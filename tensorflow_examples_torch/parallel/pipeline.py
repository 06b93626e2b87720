"""Pipeline parallelism over the ``pipe`` mesh axis, GPipe and 1F1B: the
port of ``tensorflow_examples_tpu/parallel/pipeline.py``, as per-rank
code.

Stage parameters are one stacked tree whose leading layer dim is split
over ``pipe`` (a sharding rule, ``workloads/gpt2.py``): each rank holds
its stage's layers and runs them. The reference runs its schedules inside
a ``shard_map`` manual over ``pipe`` only; here each process already is
one pipe rank, and ``data``/``model`` work inside a stage is the per-rank
code of the non-pipelined model (its TP collectives over ``model``).

* **GPipe** (:func:`pipeline_apply`): microbatches stream over M + P - 1
  ticks; stage s computes at ticks s .. s + M - 1 and skips the bubble
  ticks (the reference's ``lax.cond``). The activation hop is
  ``collectives.ppermute`` around the ``pipe`` ring, whose backward is
  the inverse hop, so autograd differentiates through the schedule. The
  input enters through ``copy_to`` (only stage 0 reads it: the backward
  sums its cotangent over ``pipe``) and the last stage's outputs leave
  through ``psum`` (every rank then holds them). Each tick's hop input
  depends on the previous tick's output on every rank
  (``collectives.depend``), so every rank's backward meets the hops in
  the same order, last tick first.
* **1F1B** (:func:`pipeline_1f1b`): the training schedule, interleaved
  over ``v`` virtual stages a rank when ``v`` > 1. The tick tables come
  from the numpy simulation :func:`_schedule_1f1b` (copied from the
  reference with its invariants). A forward tick runs a stage without a
  graph and stashes its input; the last virtual stage also takes the
  microbatch's loss. A backward tick recomputes its stage from the stash
  and takes ``torch.autograd.grad`` of it, accumulating the stage's
  parameter gradients (and, at the last virtual stage, the head's). The
  whole table runs inside the forward of a ``torch.autograd.Function``
  (the reference's ``custom_vjp`` ``run_fwd``), whose backward scales
  the saved gradients by the incoming cotangent (``run_bwd``). The loss,
  the head's gradients and the input's are summed over ``pipe`` (bf16
  through f32, :func:`_psum_pipe`), so every rank reports the same loss
  and holds whole head and embedding gradients.

Each 1F1B tick's hops are posted from the table, which every rank holds:
a rank sends its activation forward (its gradient backward) when it ran
that op on the last tick, and the neighbour posts the matching receive
(``collectives.point_to_point``), so the pairs agree on every rank with
nothing sent on idle ticks.

Each 1F1B run sets this rank's gauges in the telemetry registry, which
the trainer's telemetry lines carry under ``gauges``:
``pipeline/ticks`` (the table's), ``pipeline/idle_ticks`` (this rank's
bubble), and the host seconds of the run, ``pipeline/wall_s``, and of
its hops, ``pipeline/exchange_s`` (which wait for the device work queued
before them and for the neighbour).
"""

from __future__ import annotations

import time
from typing import Callable, Mapping

import numpy as np
import torch

from tensorflow_examples_torch.core import collectives as coll
from tensorflow_examples_torch.core.mesh import AxisNames
from tensorflow_examples_torch.telemetry.registry import default_registry

_PIPE = AxisNames.PIPE


def _psum_pipe(tensors: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Sum each tensor over ``pipe`` in one all-reduce, not differentiated;
    sub-f32 tensors go through f32 and back, as the reference's
    ``_psum_pipe`` rounds them."""
    if not tensors:
        return []
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    flat = coll._all_reduce(flat, _PIPE, mesh)
    pieces = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(pieces, tensors)]


def pipeline_apply(stage_fn: Callable, x: torch.Tensor, *, mesh,
                   num_microbatches: int) -> torch.Tensor:
    """This rank's stage over ``x`` [batch, ...] with GPipe scheduling;
    returns the last stage's output [batch, ...] on every rank.
    ``stage_fn(h, mb)`` applies this rank's stage to microbatch ``mb``'s
    activations ``h``."""
    n_stages = mesh.axis_size(_PIPE)
    if n_stages == 1:
        return stage_fn(x, 0)
    m, b = num_microbatches, x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by num_microbatches {m}")
    stage = mesh.axis_index(_PIPE)
    x_mb = coll.copy_to(x, _PIPE, mesh=mesh).reshape(m, b // m, *x.shape[1:])
    perm = coll.ring_perm(n_stages)
    state = coll.depend(torch.zeros_like(x_mb[0]), x_mb)
    outs, y = [], None
    for t in range(m + n_stages - 1):
        if stage <= t <= stage + m - 1:
            y = stage_fn(x_mb[t] if stage == 0 else state, t - stage)
        else:  # the bubble: no compute
            y = torch.zeros_like(state)
        y = coll.depend(y, state)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs.append(y)
        if t < m + n_stages - 2:  # the last tick's hop would arrive nowhere
            (state,) = coll.ppermute([y], _PIPE, mesh=mesh, perm=perm)
    out = (torch.stack(outs) if stage == n_stages - 1 else torch.zeros_like(x_mb))
    out = coll.psum(coll.depend(out, y), _PIPE, mesh=mesh)
    return out.reshape(b, *x.shape[1:])


# ------------------------------------------------------------------ 1F1B


def interleave_perm(p: int, v: int) -> np.ndarray:
    """Slot-major permutation for interleaved stages.

    Virtual stage ``s = chunk·P + device`` (round-robin, Megatron
    layout) is stored in stacked-param slot ``i = device·v + chunk`` so
    a CONTIGUOUS dim-0 ``pipe`` sharding of the ``[P·v, ...]`` stack
    gives each device exactly its v chunks with zero train-time data
    movement. Returns ``perm`` with ``perm[i] = virtual stage in slot
    i``; apply as ``stacked_logical[perm]`` to produce slot order (and
    ``argsort(perm)`` to undo, e.g. for the eval/GPipe path)."""
    return np.asarray(
        [(i % v) * p + i // v for i in range(p * v)], np.int64
    )


def _sim_schedule(m: int, p: int, v: int, bwd_hi: bool, fwd_lo: bool):
    """One greedy simulation of (interleaved) 1F1B; see _schedule_1f1b."""
    s_total = p * v
    next_f = [0] * s_total
    next_b = [0] * s_total
    f_tick: dict = {}
    b_tick: dict = {}
    ops, mbs, chs = [], [], []
    t = 0
    while any(next_b[s] < m for s in range(s_total)):
        if t > 4 * (m * v + s_total) + 8:
            return None  # this policy deadlocked / stalled
        op_row = [0] * p
        mb_row = [0] * p
        ch_row = [0] * p
        for d in range(p):
            stages = [j * p + d for j in range(v)]  # this device's chunks
            b_cands = []
            f_cands = []
            for s in stages:
                b = next_b[s]
                if b < m and (
                    (s == s_total - 1 and f_tick.get((b, s), t) < t)
                    or (s < s_total - 1 and b_tick.get((b, s + 1), t) < t)
                ):
                    b_cands.append(s)
                f = next_f[s]
                # In-flight bound: the classic S - s, additionally
                # capped at 2P for v > 1 — uncapped, greedy warmup
                # pumps up to m microbatches in flight at chunk 0
                # (GPipe-like memory); the cap costs ≤1% ticks in the
                # swept configs and bounds stash depth by min(m, 2P).
                # For v == 1, S - s ≤ P < 2P: identical to round 3.
                if (
                    f < m
                    and (s == 0 or f_tick.get((f, s - 1), t) < t)
                    and next_f[s] - next_b[s] < min(s_total - s, 2 * p)
                ):
                    f_cands.append(s)
            if b_cands:  # backward priority (1F1B)
                s = max(b_cands) if bwd_hi else min(b_cands)
                b = next_b[s]
                op_row[d], mb_row[d], ch_row[d] = 2, b, s // p
                b_tick[(b, s)] = t
                next_b[s] += 1
            elif f_cands:
                s = min(f_cands) if fwd_lo else max(f_cands)
                f = next_f[s]
                op_row[d], mb_row[d], ch_row[d] = 1, f, s // p
                f_tick[(f, s)] = t
                next_f[s] += 1
        ops.append(op_row)
        mbs.append(mb_row)
        chs.append(ch_row)
        t += 1
    return ops, mbs, chs, t, f_tick, b_tick


def _schedule_1f1b(m: int, p: int, v: int = 1):
    """Simulate the 1F1B schedule — interleaved when v > 1 — for M
    microbatches over P devices × V virtual stages (chunks) per device,
    and return static per-tick op tables.

    Virtual stage ``s = chunk·P + device``; each device runs at most
    ONE op per tick among its chunks. Greedy rules per tick, per
    device: run a backward whose cotangent is available (last virtual
    stage: own forward done earlier; else: stage s+1 ran backward
    earlier) — backward priority; else a forward whose activation is
    available (s == 0: always; else s-1 forwarded earlier) subject to
    the in-flight bound ``next_f[s] - next_b[s] < S - s``; else idle.
    Four chunk tie-break policies are simulated and the one with the
    fewest ticks that converges wins (for v == 1 they coincide with the
    round-3 schedule exactly).

    Returns (op[T,P], mb[T,P], ch[T,P], T, depth, q_f, q_b) int32
    arrays, op ∈ {0 idle, 1 fwd, 2 bwd}; ``depth`` is the exact max
    in-flight count over (device, chunk) pairs from the simulation —
    the runtime sizes its activation stash [v, depth, ...] from it —
    and ``q_f``/``q_b`` are the exact max arrived-but-unconsumed counts
    per receive direction, sizing the [v, q, ...] receive queues (v=1
    gives the classic 2 slots; interleaving legitimately needs more
    during warmup because a device is busy with other chunks while
    arrivals pile up). Asserts the slot-reuse invariants the runtime
    relies on at the computed sizes (slot = mb % size).
    """
    s_total = p * v
    best = None
    for bwd_hi in (True, False):
        for fwd_lo in (True, False):
            r = _sim_schedule(m, p, v, bwd_hi, fwd_lo)
            if r is not None and (best is None or r[3] < best[3]):
                best = r
    if best is None:
        raise AssertionError(f"1F1B schedule failed to converge (m={m}, p={p}, v={v})")
    ops, mbs, chs, t, f_tick, b_tick = best

    # Exact stash depth: max simultaneous in-flight per virtual stage.
    depth = 1
    for s in range(s_total):
        live = 0
        events = sorted(
            [(f_tick[(k, s)], 1) for k in range(m)]
            + [(b_tick[(k, s)], -1) for k in range(m)]
        )
        for _, delta in events:
            live += delta
            depth = max(depth, live)
    # Exact receive-queue sizes: max arrived-but-unconsumed per virtual
    # edge. A forward produced at stage s-1 on tick u arrives at stage s
    # on tick u+1 and is consumed at f_tick[(k, s)].
    def _max_live(ticks, lo, hi, shift):
        live_max = 1
        for s in range(lo, hi):
            # Arrival one tick after production at the neighbor; the
            # +0.5 orders consumption after a same-tick arrival (the
            # runtime delivers arrivals at tick start, then consumes).
            events = sorted(
                [(ticks[(k, s + shift)] + 1, 1) for k in range(m)]
                + [(ticks[(k, s)] + 0.5, -1) for k in range(m)]
            )
            live = 0
            for _, delta in events:
                live += delta
                live_max = max(live_max, live)
        return live_max

    q_f = _max_live(f_tick, 1, s_total, -1)
    q_b = _max_live(b_tick, 0, s_total - 1, +1)
    q_f, q_b = max(2, q_f), max(2, q_b)
    # Queue invariant at the computed sizes: arrival of microbatch k+q
    # (same direction, same edge) must not precede consumption of k.
    for s in range(1, s_total):
        for k in range(m - q_f):
            assert f_tick[(k, s)] <= f_tick[(k + q_f, s - 1)], (s, k)
    for s in range(s_total - 1):
        for k in range(m - q_b):
            assert b_tick[(k, s)] <= b_tick[(k + q_b, s + 1)], (s, k)
    # Stash invariant: backward of k precedes forward of k+depth
    # (slot = mb % depth reuse safety).
    for s in range(s_total):
        for k in range(m - depth):
            assert b_tick[(k, s)] < f_tick[(k + depth, s)], (s, k)
    return (
        np.asarray(ops, np.int32),
        np.asarray(mbs, np.int32),
        np.asarray(chs, np.int32),
        t,
        depth,
        q_f,
        q_b,
    )


def _hops(tables, t: int, dev: int, n_dev: int, n_virtual: int):
    """What tick ``t`` delivers (the hops of tick t - 1), from the table
    every rank holds: ``(send_fwd, send_bwd, recv_fwd, recv_bwd)``, each
    None or the (chunk, microbatch) it carries, on the receiving side's
    chunk for a receive."""
    op, mb, ch = tables
    s_total = n_dev * n_virtual
    prev = t - 1
    pred, succ = (dev - 1) % n_dev, (dev + 1) % n_dev
    s_me = ch[prev, dev] * n_dev + dev
    send_f = send_b = recv_f = recv_b = None
    if op[prev, dev] == 1 and s_me < s_total - 1:
        send_f = True
    if op[prev, dev] == 2 and s_me > 0:
        send_b = True
    s_pred = ch[prev, pred] * n_dev + pred
    if op[prev, pred] == 1 and s_pred < s_total - 1:
        recv_f = ((s_pred + 1) // n_dev, int(mb[prev, pred]))
    s_succ = ch[prev, succ] * n_dev + succ
    if op[prev, succ] == 2 and s_succ > 0:
        recv_b = ((s_succ - 1) // n_dev, int(mb[prev, succ]))
    return send_f, send_b, recv_f, recv_b


def _run_1f1b(stage_fn, head_loss_fn, stage: dict, head: dict, x: torch.Tensor,
              labels: torch.Tensor, mesh, m: int, v: int):
    """This rank's tick table: ``(loss sum, stage grads, head grads, dx)``
    before the ``pipe`` reduction; the loss and head gradients are this
    rank's only where it hosts the last virtual stage, ``dx`` only on
    the first, zeros elsewhere."""
    n_dev, dev = mesh.axis_size(_PIPE), mesh.axis_index(_PIPE)
    s_total = n_dev * v
    op, mb_tbl, ch_tbl, n_ticks, depth, q_f, q_b = _schedule_1f1b(m, n_dev, v)
    tables = (op, mb_tbl, ch_tbl)
    rows = next(iter(stage.values())).shape[0]
    per = rows // v
    chunks = [{n: p[j * per:(j + 1) * per] for n, p in stage.items()} for j in range(v)]
    x_mb = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    labels_mb = labels.reshape(m, labels.shape[0] // m, *labels.shape[1:])
    d_stage = {n: torch.zeros_like(p) for n, p in stage.items()}
    d_head = {n: torch.zeros_like(p) for n, p in head.items()}
    dx = torch.zeros_like(x_mb)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    in_q: dict = {}    # (chunk, mb) -> arrived activation
    d_q: dict = {}     # (chunk, mb) -> arrived cotangent
    stash: dict = {}   # (chunk, mb) -> the stage input, kept for the backward tick
    y_pay = d_pay = None
    t_run, exchange_s = time.perf_counter(), 0.0
    for t in range(n_ticks):
        if t > 0:
            t_hop = time.perf_counter()
            send_f, send_b, recv_f, recv_b = _hops(tables, t, dev, n_dev, v)
            ops = []
            if send_f:
                ops.append(("send", y_pay, (dev + 1) % n_dev))
            if recv_f:
                ops.append(("recv", x_mb[0], (dev - 1) % n_dev))
            if send_b:
                ops.append(("send", d_pay, (dev - 1) % n_dev))
            if recv_b:
                ops.append(("recv", x_mb[0], (dev + 1) % n_dev))
            got = iter(coll.point_to_point(ops, _PIPE, mesh=mesh))
            if recv_f:
                in_q[recv_f] = next(got)
            if recv_b:
                d_q[recv_b] = next(got)
            assert len(in_q) <= v * q_f and len(d_q) <= v * q_b, (t, len(in_q), len(d_q))
            exchange_s += time.perf_counter() - t_hop
        kind = op[t, dev]
        if kind == 0:
            continue
        k, j = int(mb_tbl[t, dev]), int(ch_tbl[t, dev])
        s = j * n_dev + dev
        last = s == s_total - 1
        if kind == 1:
            x_in = x_mb[k] if s == 0 else in_q.pop((j, k))
            with torch.no_grad():
                y_pay = stage_fn(chunks[j], x_in, j, k)
                if last:
                    loss = loss + head_loss_fn(head, y_pay, labels_mb[k]).float()
            stash[(j, k)] = x_in
            assert len(stash) <= v * depth, (t, len(stash))
            continue
        x_in = stash.pop((j, k))
        with torch.enable_grad():
            p_leaf = {n: p.detach().requires_grad_(True) for n, p in chunks[j].items()}
            x_leaf = x_in.detach().requires_grad_(True)
            y = stage_fn(p_leaf, x_leaf, j, k)
            wrt = [*p_leaf.values(), x_leaf]
            if last:
                h_leaf = {n: p.detach().requires_grad_(True) for n, p in head.items()}
                out = head_loss_fn(h_leaf, y, labels_mb[k])
                grads = torch.autograd.grad(out, [*h_leaf.values(), *wrt], allow_unused=True)
                for (n, acc), g in zip(d_head.items(), grads):
                    if g is not None:
                        acc += g
                grads = grads[len(h_leaf):]
            else:
                grads = torch.autograd.grad(y, wrt, grad_outputs=d_q.pop((j, k)),
                                            allow_unused=True)
        for (n, acc), g in zip(d_stage.items(), grads):
            if g is not None:
                acc[j * per:(j + 1) * per] += g
        if s == 0:
            dx[k] = grads[-1]
        else:
            d_pay = grads[-1]
    assert not (in_q or d_q or stash), "1F1B table left work undone"
    reg = default_registry()
    for name, value in (("ticks", n_ticks), ("idle_ticks", int((op[:, dev] == 0).sum())),
                        ("wall_s", time.perf_counter() - t_run), ("exchange_s", exchange_s)):
        reg.gauge(f"pipeline/{name}").set(value)
    return loss, d_stage, d_head, dx.reshape(x.shape)


class _OneFOneB(torch.autograd.Function):
    """The 1F1B schedule as one autograd node: ``forward`` runs the tick
    table and keeps the gradients it took (the reference's ``run_fwd``);
    ``backward`` scales them by the cotangent (``run_bwd``)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        loss, grads = run(x, leaves)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, g):
        dx, *d_leaves = ctx.saved_tensors
        return (None, (dx * g).to(dx.dtype), *((d * g).to(d.dtype) for d in d_leaves))


def pipeline_1f1b(stage_fn: Callable, head_loss_fn: Callable, stage_params: Mapping,
                  head_params: Mapping, x: torch.Tensor, labels: torch.Tensor, *, mesh,
                  num_microbatches: int, num_virtual_stages: int = 1) -> torch.Tensor:
    """The 1F1B pipelined loss, ``mean`` over microbatches of
    ``head_loss_fn``, differentiable in ``x``, ``stage_params`` and
    ``head_params``; every ``pipe`` rank returns it.

    * ``stage_params``: ``{name: [v·k, ...]}``, this rank's stacked rows
      in slot-major order (chunk j's k rows are virtual stage
      ``j·P + rank``, :func:`interleave_perm`);
    * ``stage_fn(chunk_params, h, chunk, mb) -> y``: one chunk's layers
      on microbatch ``mb``'s activations (a chunk's ``{name: [k, ...]}``);
    * ``head_loss_fn(head_params, y, labels) -> scalar``: the microbatch's
      mean loss, run at the last virtual stage only;
    * ``x`` [batch, ...]: the stage-0 input (the embedding's output), on
      every rank; ``labels`` [batch, ...] its labels.

    ``num_virtual_stages`` v > 1 is interleaved 1F1B (Megatron's): each
    tick runs a 1/v-sized chunk, and the ramp shrinks about v-fold in
    full-stage units at the price of v times the ticks and hops."""
    m, v = num_microbatches, num_virtual_stages
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by num_microbatches {m}")
    stage_names, head_names = list(stage_params), list(head_params)

    def run(x_in, leaves):
        stage = dict(zip(stage_names, (t.detach() for t in leaves[:len(stage_names)])))
        head = dict(zip(head_names, (t.detach() for t in leaves[len(stage_names):])))
        loss, d_stage, d_head, dx = _run_1f1b(stage_fn, head_loss_fn, stage, head,
                                              x_in.detach(), labels, mesh, m, v)
        loss, *reduced = _psum_pipe([loss, *d_head.values(), dx], mesh)
        d_head_r, dx = reduced[:-1], reduced[-1]
        return loss / m, [dx / m, *(g / m for g in d_stage.values()),
                          *(g / m for g in d_head_r)]

    return _OneFOneB.apply(run, x, *stage_params.values(), *head_params.values())
