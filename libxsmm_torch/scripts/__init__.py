"""The port's labs: measurement scripts run on the card.

    python3 -m libxsmm_torch.scripts.brgemm_lab [--rounds 5]
    python3 -m libxsmm_torch.scripts.bcsc_lab [--density 0.2] [--rounds 5]

Each `main(argv)` returns the rows it prints, so that other scripts
(chip_smoke.py) reuse it.
"""
