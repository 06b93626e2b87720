"""``steps_per_launch``: k train steps in one launch, the port of the
reference's bundled step (``tensorflow_examples_tpu/train/loop.py``
``_build_bundled_step``, a ``lax.scan`` of k steps).

On the card :class:`BundledStep` captures the k steps into one
``torch.cuda.CUDAGraph`` per bundle signature: each step's forward,
``autograd.grad``, clipping, AdamW and the bad-step select, reading a
static ``[k, B, ...]`` bundle and writing the last step's state back
into static state buffers. The first call copies the state into those
buffers, runs the k steps eagerly on a side stream (the kernels' build,
cuBLAS workspaces and the allocator warm up outside the capture; the
results are discarded), then captures; a failed capture raises, it
never runs eager in its place. A replay takes no Python, so the kernel
wrappers' launch counters move by the tally the capture recorded
(``core/graphs.py``). The state a call returns holds the static buffers;
a call handed any other state (a restored checkpoint, a rollback)
copies it into them first. Metrics come back stacked ``[k]``, copied out
of the graph's outputs before the next replay can overwrite them. On
the CPU the k steps run as a loop.

Randomness inside the graph: a step's dropout masks and MoE router
jitter must stay a pure function of (seed, step), so resume and rollback
replay them, and the k steps of a launch must each draw their own. Each
step of the launch has its own ``core/rng.StepNoise``, the eager step's
noise source: its per-site CUDA generators are registered with the
graph, and its router jitter lives in device buffers the graph reads.
Before each replay the host stages step i's noise from step i's key:
each generator is reseeded to ``core/rng.site_seed(step key, site)`` at
offset 0, exactly as the eager step reseeds it, so a graph step draws
the eager step's masks bit for bit, and each block's jitter is computed
on the host and copied into its buffer. Inside the graph the step
number is a 0-d int64 device tensor (``TrainState.step``), set from the
host's count before each replay and advanced by the captured steps.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import torch

from tensorflow_examples_torch.core import graphs as graphs_mod
from tensorflow_examples_torch.core import rng
from tensorflow_examples_torch.ops import attention, cross_entropy, grouped_matmul
from tensorflow_examples_torch.train import optimizers

# Every kernel wrapper a training step can launch: their counters move
# by a capture's tally at each replay.
TRAIN_KERNELS = (attention.flash_fwd, attention.flash_bwd_dkv, attention.flash_bwd_dq,
                 cross_entropy.ce_fwd, cross_entropy.ce_bwd, grouped_matmul.gmm,
                 grouped_matmul.tgmm, grouped_matmul.group_row_sum)


def cuda_graph(fn: Callable, generators, kernels=TRAIN_KERNELS):
    """Capture ``fn`` into a CUDA graph with ``generators`` registered:
    (graph, fn's output, launch tally)."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    out, tally = graphs_mod.capture(torch.cuda.graph(graph), fn, kernels)
    return graph, out, tally


@dataclasses.dataclass
class _Entry:
    graph: object
    static: object       # TrainState over the static buffers, step a device tensor
    bundle: dict         # static [k, B, ...] inputs
    metrics: dict        # the graph's [k] metric outputs
    tally: dict
    bound: object = None  # the TrainState last returned (its tensors are static)


class BundledStep:
    """``(state, bundle) -> (state, metrics [k])`` for k steps of
    ``trainer``. ``graph_factory(fn, generators) -> (graph, out, tally)``
    replaces the CUDA capture (a test hands in a stand-in whose replay
    reruns ``fn``); ``graph=None`` captures on the card and loops on the
    CPU."""

    def __init__(self, trainer, k: int, *, graph: bool | None = None,
                 graph_factory: Callable | None = None):
        self.trainer = weakref.proxy(trainer)  # the trainer holds this object
        self.k = int(k)
        self.device = trainer.device
        self.graph = self.device.type == "cuda" if graph is None else graph
        self._factory = graph_factory or cuda_graph
        self._entries: dict[tuple, _Entry] = {}
        self._noises = [rng.StepNoise() for _ in range(self.k)]

    @property
    def captured(self) -> int:
        return len(self._entries)

    def tallies(self) -> list[dict]:
        """Each graph's launches a replay, ``{"kernel.counter": n}``."""
        return [{f"{fn.__name__}.{name}": n for (fn, name), n in e.tally.items()}
                for e in self._entries.values()]

    def needs_capture(self, bundle: dict) -> bool:
        """Whether the next call on ``bundle`` captures a new graph."""
        return self.graph and _signature(bundle) not in self._entries

    def __call__(self, state, bundle: dict):
        trainer = self.trainer
        self._stage(state.step)
        if not self.graph:
            return trainer.run_steps(state, bundle, self._noises)
        sig = _signature(bundle)
        entry = self._entries.get(sig)
        if entry is None:
            entry = self._entries[sig] = self._record(state, bundle)
            self._stage(state.step)  # the warm-up and the capture drew from them
        if state is not entry.bound:
            _copy_state(entry.static, state)
        for name, t in bundle.items():
            entry.bundle[name].copy_(t, non_blocking=True)
        entry.static.step.fill_(state.step)
        entry.graph.replay()
        graphs_mod.add_tally(entry.tally)
        entry.bound = dataclasses.replace(entry.static, step=state.step + self.k)
        return entry.bound, {name: m.clone() for name, m in entry.metrics.items()}

    def _stage(self, step: int) -> None:
        """Step i of the launch draws from step ``step + i``'s key."""
        for i, noise in enumerate(self._noises):
            self.trainer.stage_noise(noise, step + i)

    def _record(self, state, bundle) -> _Entry:
        clone = lambda t: t.detach().clone()
        static = dataclasses.replace(
            state, step=torch.tensor(state.step, dtype=torch.int64, device=self.device),
            params=optimizers.tree_map(clone, state.params),
            opt_state=optimizers.tree_map(clone, state.opt_state),
            model_state=optimizers.tree_map(clone, state.model_state))
        inputs = {name: clone(t) for name, t in bundle.items()}
        run = lambda: self.trainer.run_steps(dataclasses.replace(static), inputs, self._noises)
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                run()  # warm-up: functional steps, nothing written back
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            run()

        def captured():
            new, metrics = run()
            _copy_state(static, new)
            return metrics

        generators = [g for noise in self._noises for g in noise.generators]
        try:
            graph, metrics, tally = self._factory(captured, generators)
        except Exception as e:
            raise RuntimeError(f"capturing {self.k} train steps as one CUDA graph failed "
                               f"(steps_per_launch={self.k}; no eager fallback): {e}") from e
        return _Entry(graph, static, inputs, metrics, tally)


def _signature(bundle: dict) -> tuple:
    return tuple((name, tuple(t.shape), t.dtype) for name, t in bundle.items())


def _copy_state(dst, src) -> None:
    """``src``'s tensors (and step) into ``dst``'s static buffers."""
    for part in ("params", "opt_state", "model_state"):
        for d, s in zip(optimizers.tree_leaves(getattr(dst, part)),
                        optimizers.tree_leaves(getattr(src, part))):
            d.copy_(s)
    if torch.is_tensor(src.step):
        dst.step.copy_(src.step)
