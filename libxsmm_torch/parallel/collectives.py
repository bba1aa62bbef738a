"""The collectives of the parallel layer, on torch.distributed process groups.

New in the port: the counterparts of the `jax.lax` collectives that the
reference's `shard_map` bodies call (`ppermute`, `all_to_all` and
`all_gather` with `tiled=True`, `axis_index`, and the `psum` that
`shard_map`'s transpose derives for replicated weights), so the bodies
issue exactly the reference's collectives. Bodies call these on the local
tensors of their DTensors (`to_local()`), never through DTensor's implicit
redistribution, so every collective is one that this module issued.

Semantics, as `jax.lax`'s:
  * ppermute(x, group, perm): perm holds (source, destination) pairs of
    axis indices; a rank that no pair sends to receives zeros;
  * all_to_all(x, group, split_axis, concat_axis): x is cut into P equal
    chunks along split_axis, chunk j goes to axis index j, and the chunks
    received are concatenated along concat_axis in the order of their
    source index (jax.lax.all_to_all(..., tiled=True));
  * all_gather(x, group, axis): the P blocks concatenated along `axis` in
    index order (tiled=True);
  * all_reduce(x, group): the sum over the group;
  * reduce_scatter(x, group, axis): the sum over the group, cut into P
    blocks along `axis`, block i to index i (jax.lax.psum_scatter, tiled).
All of them are autograd Functions, for the collectives that GSPMD derives
in the reference's sharded train steps and the port writes out
(parallel/spmd.py): ppermute's backward is the inverse permutation,
all_to_all's the reverse all-to-all, reduce_scatter's an all-gather;
all_reduce's is the identity (the sum is consumed alike on every rank, as
after a row-parallel product), all_gather's a reduce-scatter, or the rank's
own block where the gathered tensor is consumed alike on every rank
(replicated=True). copy_to (identity forward, all-reduce backward) is the
other half of Megatron's pair, and psum (all-reduce both ways) the sum of a
value whose consumers differ from rank to rank.

The log. Every issued collective, forward or backward, appends one entry
to `log` with its kind in the reference's vocabulary ("collective_permute",
"all_to_all", "all_gather", "all_reduce", "reduce_scatter"), its payload
bytes, shape, dtype and group size, whether it was staged (below), whether
it was issued as a start with a separate wait (`ppermute_start`), and how
many compute steps the caller marked (`mark_compute`) before it was issued
and while it was in flight.
The log stands where the reference parses lowered HLO (`lowered_text`):
tests and chip_smoke.py hold its bytes against the comm models.
"bytes" counts what the reference's comm models count: a permute's whole
payload (a permute to this rank itself is a local copy, logged as the
lowered program would hold it), the (P-1)/P of an all-to-all's operand that
leaves the rank, the P-1 blocks an all-gather brings in, 2 (P-1)/P of an
all-reduce's operand (a ring all-reduce) and (P-1)/P of a reduce-scatter's.

On a group of one rank every collective is local, as XLA elides it on one
device: a permute to itself is a copy, an all-to-all or all-gather returns
its operand, an all-reduce a copy. No backend call is issued (with four
one-rank NCCL all-to-alls, Ulysses at flash's bench shape took 1.91 ms a
forward on the H100, without them 0.31: PERF.md), and the log marks the
entry "peer": "self".

Staging. gloo takes no card tensors for some collectives (send and
receive among them). On a gloo group, card tensors go through pinned host
buffers: copied out, exchanged, copied back; the log marks such entries
"staged". That is the transport of several ranks sharing one card (NCCL
refuses two ranks on one card), not a fallback: the backend is never
swapped after a failure, and the computation stays on the card.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# every collective issued since the last reset_log(), in issue order
log: List[dict] = []
# compute steps marked (mark_compute) since the last reset_log()
_marks = [0]


def reset_log() -> None:
    log.clear()
    _marks[0] = 0


def mark_compute() -> None:
    """Note that the caller ran one compute step (the SpMM's block
    multiplies): the log records how many ran before each collective was
    issued and while it was in flight."""
    _marks[0] += 1


def logged_bytes(kind: str = None) -> int:
    """Payload bytes of the logged collectives (of one kind, or all)."""
    return sum(e["bytes"] for e in log if kind is None or e["kind"] == kind)


def axis_index(group) -> int:
    """This rank's index in `group` (jax.lax.axis_index)."""
    return dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card tensor."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _record(kind: str, nbytes: int, t: torch.Tensor, group, staged: bool,
            started: bool = False, peer: str = "") -> dict:
    entry = {"kind": kind, "bytes": int(nbytes), "shape": tuple(t.shape),
             "dtype": str(t.dtype).split(".")[-1],
             "group_size": dist.get_world_size(group), "staged": staged,
             "started": started, "computes_before": _marks[0],
             "computes_in_flight": 0}
    if peer:
        entry["peer"] = peer
    log.append(entry)
    return entry


class Handle:
    """Collectives in flight: wait() completes them and returns their
    results (a tuple, one per operand)."""

    def __init__(self, works, finish: Callable[[], Tuple[torch.Tensor, ...]],
                 entries: List[dict]):
        self._works, self._finish, self._entries = works, finish, entries

    def wait(self) -> Tuple[torch.Tensor, ...]:
        for w in self._works:
            w.wait()
        for e in self._entries:
            e["computes_in_flight"] = _marks[0] - e["computes_before"]
        return self._finish()


Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def ppermute_start(xs: Tensors, group, perm, started: bool = True) -> Handle:
    """Issue ppermute for each of `xs` (one send/receive batch, one log
    entry each) and return the Handle; the caller may compute before
    waiting on it."""
    xs = (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)
    me = dist.get_rank(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at index {me}")
    ops, entries, outs, backs = [], [], [], []
    for x in xs:
        x = x.contiguous()
        if dsts == [me] and srcs == [me]:
            outs.append(x.clone())
            backs.append(None)
            entries.append(_record("collective_permute", x.nbytes, x, group,
                                   False, started, peer="self"))
            continue
        staged = _staged(group, x)
        if staged:
            send, recv = _host(x), torch.empty(x.shape, dtype=x.dtype,
                                               pin_memory=True)
        else:
            send, recv = x, torch.empty_like(x)
        if dsts:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dsts[0]),
                                  group))
        if srcs:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, srcs[0]),
                                  group))
        else:
            recv.zero_()
        outs.append(recv)
        backs.append(x.device if staged else None)
        entries.append(_record("collective_permute", x.nbytes, x, group,
                               staged, started))
    works = dist.batch_isend_irecv(ops) if ops else []

    def finish():
        return tuple(o if dev is None else o.to(dev)
                     for o, dev in zip(outs, backs))

    return Handle(works, finish, entries)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, tuple(perm)
        return ppermute_start(x, group, perm, started=False).wait()[0]

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return (ppermute_start(g, ctx.group, inverse,
                               started=False).wait()[0], None, None)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """jax.lax.ppermute over `group`; differentiable (the backward sends
    the cotangent along the inverse permutation)."""
    return _PPermute.apply(x, group, tuple(perm))


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """The reference's ring: index i sends to (i + 1) mod n."""
    return [(i, (i + 1) % n) for i in range(n)]


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not split into {n}")
    if n == 1:
        _record("all_to_all", 0, x, group, False, peer="self")
        return x
    send = torch.stack(torch.tensor_split(x, n, dim=split_axis))
    staged = _staged(group, x)
    _record("all_to_all", x.nbytes * (n - 1) // n, x, group, staged)
    if staged:
        send = _host(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, ctx.group, concat_axis, split_axis), None,
                None, None)


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)
    over `group`; differentiable (the backward is the reverse
    all-to-all)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    if n == 1:
        _record("all_gather", 0, x, group, False, peer="self")
        return x
    staged = _staged(group, x)
    _record("all_gather", x.nbytes * (n - 1), x, group, staged)
    src = _host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=axis)
    return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        _record("all_reduce", 0, x, group, False, peer="self")
        return x.clone(memory_format=torch.contiguous_format)
    staged = _staged(group, x)
    _record("all_reduce", 2 * x.nbytes * (n - 1) // n, x, group, staged)
    out = _host(x) if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out.to(x.device) if staged else out


def _reduce_scatter(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The sum over the group, cut into P blocks along `axis`, block i kept
    by index i: one all-to-all of the P blocks (the (P-1)/P of the operand
    a ring reduce-scatter moves), then the received blocks summed in index
    order, so every rank adds the same terms in the same order."""
    n = dist.get_world_size(group)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: axis {axis} of size "
                         f"{x.shape[axis]} does not split into {n}")
    if n == 1:
        _record("reduce_scatter", 0, x, group, False, peer="self")
        return x.clone(memory_format=torch.contiguous_format)
    send = torch.stack(torch.tensor_split(x, n, dim=axis))
    staged = _staged(group, x)
    _record("reduce_scatter", x.nbytes * (n - 1) // n, x, group, staged)
    if staged:
        send = _host(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    out = recv[0].clone()
    for i in range(1, n):
        out += recv[i]
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, replicated):
        ctx.group, ctx.axis, ctx.replicated = group, axis, replicated
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            n = dist.get_world_size(ctx.group)
            block = torch.tensor_split(g, n, dim=ctx.axis)[
                dist.get_rank(ctx.group)]
            return block.contiguous(), None, None, None
        return _reduce_scatter(g, ctx.group, ctx.axis), None, None, None


def all_gather(x: torch.Tensor, group, axis: int = 0,
               replicated: bool = False) -> torch.Tensor:
    """jax.lax.all_gather(x, axis_name, axis=axis, tiled=True);
    differentiable. The backward gives each rank its block of the gradient
    summed over the group (a reduce-scatter: every rank's consumers of the
    gathered tensor differ, as the GCN's block rows do). replicated=True
    says every rank of the group consumes the gathered tensor the same way
    and holds the whole gradient already, so the backward takes this
    rank's block of its own gradient and issues nothing."""
    return _AllGather.apply(x, group, axis, bool(replicated))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` (jax.lax.psum), as a new tensor;
    differentiable. The backward is the identity on each rank: the sum is
    consumed the same way on every rank (replicated), each rank holds the
    whole gradient of it, and a rank's own term gets exactly that
    (Megatron's g: all-reduce forward, identity backward, after a
    row-parallel product)."""
    return _AllReduce.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity forward, an all-reduce backward. Put
    where a value replicated over the group enters work that each rank does
    on its own share (a column-parallel product): each rank's gradient of
    it is partial, and the backward sums them."""
    return _CopyTo.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of a value whose consumers differ from rank
    to rank: an all-reduce forward and an all-reduce backward (the
    transpose of jax.lax.psum inside shard_map on an unreplicated
    operand): all_reduce(copy_to(x))."""
    return all_reduce(copy_to(x, group), group)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _reduce_scatter(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.axis), None, None


def reduce_scatter(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """jax.lax.psum_scatter(x, axis_name, scatter_dimension=axis,
    tiled=True): the sum over the group, of which index i keeps block i
    along `axis`; differentiable (the backward all-gathers the blocks'
    gradients)."""
    return _ReduceScatter.apply(x, group, axis)
