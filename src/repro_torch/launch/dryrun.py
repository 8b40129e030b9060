"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production grids and extract the roofline terms of an NVIDIA H100.

Port of ``repro/launch/dryrun.py``. Where the JAX package lowers and
compiles one program for 256 or 512 virtual devices, the port traces the
program of one process (rank 0) of the production grid
(:func:`repro_torch.launch.mesh.make_production_mesh`: ``(16, 16)`` or
``(2, 16, 16)``) under a ``fake`` process group of that world size and
``FakeTensorMode``: every tensor has its shape, dtype and storage size and
no data, every collective runs its process-group call and moves nothing.
Each cell runs in a process of its own (the fake default process group
stays in that process). Nothing needs a card or a download.

* **train**: ``trainer.init_train_state(..., ranks=, master=, zero1=)``
  and one call of ``jit_train_step``'s step on the *global* batch of the
  shape (the step cuts this process's rows).
* **prefill**: ``init(..., ranks=)`` and ``prefill(..., caches=None,
  ranks=)`` on this process's rows of the batch.
* **decode**: ``init_caches(..., ranks=)`` and ``decode_step(...,
  ranks=)`` on this process's rows, at the cache's last slot.

Usage::

  python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun

One JSON a cell, ``{arch}__{shape}__{single|multi}.json``:

* ``counted_flops_per_device``: ``FlopCounterMode``'s total for the
  process's program (every layer runs as it is: no scan correction,
  ``scan_corrected`` false);
* ``collective_bytes_per_device``: by the JAX op names, in the JAX
  dry run's meaning (each collective's result bytes, an all-reduce
  twice), converted from :attr:`ProcessRanks.log`, which records the
  bytes of the last tensor handed to the call (:func:`collective_terms`);
  ``collective_calls``: calls and logged bytes by ``"<op> over <axes>"``;
* ``peak_live_bytes_per_device``: the most bytes of storage alive at once
  during the step, parameters, optimizer state, caches and batch
  included (:class:`LiveBytes`), the counterpart of XLA's memory
  analysis;
* ``kernel_calls``: calls of K1's wrapper (its plain version on the fake
  CPU tensors: traced, never launched);
* the JAX dry run's analytic columns, the same arithmetic over the
  port's parameter tables and a :class:`Grid` (``analytic_hbm_bytes``,
  ``state_bytes``, ``model_flops``, ``moe_active_fraction``);
* ``roofline``: the compute, memory and collective terms in seconds on
  H100 SXM5 cards (:data:`PEAK_FLOPS`, :data:`HBM_BW`, :data:`NVLINK_BW`,
  :data:`IB_BW`), the dominant one, the step bound and ``mfu_bound``.

A cell the port cannot run is written ``skipped`` with its reason:
``long_500k`` on a full-attention architecture (the JAX dry run's
reason), and a model that the grid's ``model`` axis cannot lay out
(:func:`repro_torch.train.trainer.check_grid_layout`), which waits for
ROADMAP.md's queue 1 item on those layouts. Any other exception is a
cell's ``error``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.comm import ProcessRanks, grid_coords, shard_slices
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeSpec, get_config)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Grid, dp_axes_of, make_production_mesh
from repro_torch.models.convert import jax_order, stacked_collections
from repro_torch.models.moe import padded_experts
from repro_torch.models.registry import Model, build, meta_params
from repro_torch.train.optimizer import AdamWConfig, zero1_specs
from repro_torch.train.trainer import (check_grid_layout, init_train_state,
                                       jit_train_step)

#: NVIDIA H100 SXM5 80GB, from its datasheet at the 700 W limit: dense
#: bfloat16 tensor-core FLOP/s, HBM3 bytes/s and bytes
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
#: the same datasheet: NVLink 4 bytes/s a direction a card (900 GB/s both
#: ways) inside one node, and the node's NDR InfiniBand, one 400 Gb/s
#: adapter a card, across nodes
NVLINK_BW = 450e9
IB_BW = 50e9
#: cards of one NVLink node (HGX H100 8-GPU): ranks are row-major on the
#: grid and fill the nodes in order, ranks 8n .. 8n + 7 on node n
CARDS_PER_NODE = 8
HARDWARE = {
    "card": "NVIDIA H100 SXM5 80GB, datasheet constants at 700 W",
    "peak_flops_bf16_dense": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
    "hbm_bytes": HBM_BYTES, "nvlink_bytes_per_s_one_way": NVLINK_BW,
    "infiniband_bytes_per_s": IB_BW, "cards_per_node": CARDS_PER_NODE,
    "node_rule": "ranks row-major on the grid, rank r on node r // 8; a "
                 "group inside one node runs over NVLink, else InfiniBand"}

_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute")
#: :attr:`ProcessRanks.log`'s ops by the JAX op they run
_JAX_OP = {"psum": "all-reduce", "pmax": "all-reduce",
           "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
           "all_to_all": "all-to-all"}
#: why a full-attention architecture skips ``long_500k``, the JAX dry run's
LONG_CONTEXT_SKIP = ("full attention cannot run long-context decode "
                     "(DESIGN.md §4)")
#: cells traced at once, each by a process of its own on one core
CELLS_AT_ONCE = max(1, (os.cpu_count() or 2) // 2)
#: why the rest of the cells that ``check_grid_layout`` refuses skip:
#: xLSTM-125M's recurrent heads and Whisper-small's encoder frames
LAYOUT_WAITS = ("the port cannot lay xLSTM's mLSTM and sLSTM heads or "
                "Whisper's encoder frames out over the grid's model axis "
                "yet: waits for ROADMAP.md queue 1, \"The layouts at the "
                "dry run's model = 16\"")


# -- the analytic columns (the JAX dry run's arithmetic) ----------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX package's parameter tree: a stacked
    collection's leaf holds all its layers (a leading layer axis, its
    spec led by ``None``)."""
    name: str
    shape: Tuple[int, ...]
    spec: Tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def param_leaves(cfg: ModelConfig) -> List[Leaf]:
    """The model's parameters as the JAX package's ``init`` lays them
    out (:func:`repro_torch.models.convert.jax_order`, stacked layers as
    one leaf), from the model on the ``meta`` device."""
    meta = meta_params(cfg)
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    specs = build(cfg).param_specs()
    stacked = stacked_collections(cfg)
    out: Dict[str, list] = {}
    for n in jax_order(shapes, cfg):
        parts = n.split(".")
        if parts[0] in stacked:
            key = ".".join(parts[:1] + parts[2:])
            if key in out:
                if out[key][1] != specs[n] or out[key][0] != shapes[n]:
                    raise ValueError(f"{n}: layers of one stacked leaf "
                                     f"differ")
                out[key][2] += 1
                continue
            out[key] = [shapes[n], specs[n], 1]
        else:
            out[n] = [shapes[n], specs[n], 0]
    return [Leaf(k, (layers,) + shape if layers else shape,
                 (None,) + tuple(spec) if layers else tuple(spec))
            for k, (shape, spec, layers) in out.items()]


def analytic_param_bytes(leaves: Sequence[Leaf], sizes: Mapping[str, int],
                         itemsize: int) -> int:
    """Per-device bytes of ``leaves`` (``itemsize`` bytes an element)
    implied by their specs on a grid of ``sizes``."""
    total = 0
    for leaf in leaves:
        shard = 1
        for entry in leaf.spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                shard *= sizes.get(a, 1)
        total += leaf.size * itemsize // max(shard, 1)
    return total


def moe_active_fraction(cfg: ModelConfig, leaves: Sequence[Leaf]) -> float:
    """N_active / N for ``model_flops`` (6 N_active D)."""
    total = sum(leaf.size for leaf in leaves)
    if not cfg.is_moe:
        return 1.0
    expert = sum(leaf.size for leaf in leaves
                 if "moe" in leaf.name.split(".")
                 and set(leaf.name.split(".")) & {"w_gate", "w_up",
                                                  "w_down"})
    active = total - expert + expert * cfg.top_k / padded_experts(cfg)
    return active / total


def model_flops(cfg: ModelConfig, leaves: Sequence[Leaf],
                sp: ShapeSpec) -> float:
    """The step's model FLOPs over the whole grid: 6 N_active D to train,
    2 N_active D to prefill or decode (D: the batch's tokens)."""
    n_active = sum(leaf.size for leaf in leaves) * moe_active_fraction(
        cfg, leaves)
    if sp.kind == "train":
        return 6.0 * n_active * sp.global_batch * sp.seq_len
    if sp.kind == "prefill":
        return 2.0 * n_active * sp.global_batch * sp.seq_len
    return 2.0 * n_active * sp.global_batch


def analytic_hbm_bytes(cfg: ModelConfig, sp: ShapeSpec,
                       sizes: Mapping[str, int], n_params: int,
                       zero1: bool = True) -> float:
    """The JAX dry run's per-device HBM traffic of one step:

    train: float32 parameters read forward and backward (8 B a
    parameter), the gradient written and read (8 B), AdamW's moments and
    the parameter read and written (24 B, over the data axis with
    ZeRO-1), the activations (remat: about 6 streams of L x T_loc x d
    bfloat16) and the float32 logits written and read forward and
    backward (16 B a token and vocabulary shard column);
    prefill: the parameters (4 B), 2 activation streams and the cache
    written; decode: the parameters (4 B) and the whole cache."""
    tp = sizes.get("model", 1)
    dsize = sizes.get("data", 1) * sizes.get("pod", 1)
    n_dev = n_params / tp
    b_loc = max(sp.global_batch // dsize, 1)
    if sp.kind == "train":
        t_loc = b_loc * sp.seq_len
        params_traffic = 16 * n_dev + 24 * n_dev / (dsize if zero1 else 1)
        acts = 6.0 * cfg.num_layers * t_loc * cfg.d_model * 2
        logits = 16.0 * t_loc * cfg.vocab / tp
        return params_traffic + acts + logits
    if sp.kind == "prefill":
        t_loc = b_loc * sp.seq_len
        acts = 2.0 * cfg.num_layers * t_loc * cfg.d_model * 2
        return 4 * n_dev + acts + cache_bytes_per_device(cfg, sp, sizes)
    return 4 * n_dev + cache_bytes_per_device(cfg, sp, sizes)


def cache_bytes_per_device(cfg: ModelConfig, sp: ShapeSpec,
                           sizes: Mapping[str, int]) -> float:
    """The JAX dry run's per-device cache bytes of a full context
    (``_cache_bytes_per_device``)."""
    tp = sizes.get("model", 1)
    dsize = sizes.get("data", 1) * sizes.get("pod", 1)
    b_loc = max(sp.global_batch // dsize, 1)
    t = sp.seq_len
    if cfg.family == "ssm":                    # xLSTM's matrix states
        d_in = cfg.ssm_expand * cfg.d_model
        h = max(cfg.ssm_heads or cfg.n_heads, 1)
        return cfg.num_layers * b_loc * (d_in // h) ** 2 * h * 4 / tp
    if cfg.family == "hybrid":                 # zamba2: SSM + shared KV
        d_in = cfg.ssm_expand * cfg.d_model
        h = max(d_in // 64, 1)
        ssm = cfg.num_layers * b_loc * h * 64 * cfg.ssm_state * 4
        n_shared = len([i for i in range(cfg.num_layers)
                        if cfg.attn_every and (i + 1) % cfg.attn_every == 0])
        attn = n_shared * b_loc * t * cfg.n_kv_heads * cfg.hd * 2 * 2
        return (ssm + attn) / tp
    if cfg.attn_type == "mla":                 # latent cache, replicated
        return cfg.num_layers * b_loc * t * (cfg.kv_lora_rank
                                             + cfg.qk_rope_dim) * 2
    t_eff = min(t, cfg.window) if cfg.attn_type == "swa" else t
    kv_shard = tp if cfg.n_kv_heads % tp == 0 else 1
    per_layer = b_loc * t_eff * cfg.n_kv_heads * cfg.hd * 2 * 2 / kv_shard
    return (cfg.num_layers + (cfg.enc_layers or 0)) * per_layer


def zero1_leaves(leaves: Sequence[Leaf], sizes: Mapping[str, int]
                 ) -> List[Leaf]:
    """The moments' leaves under ZeRO-1 (``optimizer.zero1_specs`` on the
    JAX tree's shapes, over ``data``)."""
    specs = zero1_specs({x.name: x.spec for x in leaves},
                        {x.name: x.shape for x in leaves}, ("data",),
                        dict(sizes))
    return [dataclasses.replace(x, spec=specs[x.name]) for x in leaves]


def analytic_columns(cfg: ModelConfig, sp: ShapeSpec, grid: Grid,
                     zero1: bool = True, bf16_params: bool = False
                     ) -> Dict[str, float]:
    """The JAX dry run's analytic numbers of a cell: the state's bytes a
    device (the parameters, float32 or with ``bf16_params`` bfloat16, and
    to train both float32 moments, ZeRO-1 sharded with ``zero1``), the
    model FLOPs over the grid and a device, the active fraction and the
    HBM traffic a device."""
    sizes = grid.sizes
    leaves = param_leaves(cfg)
    state = analytic_param_bytes(leaves, sizes, 2 if bf16_params else 4)
    if sp.kind == "train":
        moments = (zero1_leaves(leaves, sizes)
                   if zero1 and "data" in sizes else leaves)
        state += 2 * analytic_param_bytes(moments, sizes, 4)
    chips = math.prod(grid.shape)
    mf = model_flops(cfg, leaves, sp)
    n_params = sum(x.size for x in leaves)
    return {"state_bytes_per_device": int(state),
            "moe_active_fraction": moe_active_fraction(cfg, leaves),
            "model_flops_global": mf, "model_flops_per_device": mf / chips,
            "analytic_hbm_bytes_per_device": analytic_hbm_bytes(
                cfg, sp, sizes, n_params, zero1=zero1)}


# -- what a traced program measures -------------------------------------------


class LiveBytes(TorchDispatchMode):
    """The bytes of storage alive, and their peak since :meth:`reset`:
    every storage an operation returns is counted once, from its first
    appearance until it is freed (a weak reference's callback), as the
    card's allocator counts ``memory_allocated`` (without its rounding
    to blocks)."""

    def __init__(self):
        super().__init__()
        self._refs: Dict[int, Any] = {}
        self.current = 0
        self.peak = 0

    def _gone(self, key: int, nbytes: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.current -= nbytes

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._gone(key, n))
        self.current += n
        self.peak = max(self.peak, self.current)

    def reset(self) -> None:
        self.peak = self.current

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


@contextlib.contextmanager
def counting_k1(out: List[int]):
    """Each call of K1's wrapper (``kernels.ops.partition_rank``, which
    the MoE dispatch's ``partition_pack`` calls) appended to ``out``."""
    real = kops.partition_rank

    def counted(*a, **k):
        out.append(1)
        return real(*a, **k)

    kops.partition_rank = counted
    try:
        yield
    finally:
        kops.partition_rank = real


def _inputs(model: Model, sp: ShapeSpec, gen: torch.Generator,
            ranks=None, specs=None) -> Dict[str, torch.Tensor]:
    """The inputs of ``sp`` drawn from ``gen``: the whole batch, or with
    ``ranks`` and ``specs`` this process's rows. Tokens below the
    vocabulary, decode positions at the cache's last slot."""
    out = {}
    for k, (shape, dtype) in model.input_specs(sp).items():
        if ranks is not None:
            block = shard_slices(shape, specs[k], ranks.shape, ranks.axes,
                                 ranks.rank)
            shape = tuple(len(range(n)[b]) for n, b in zip(shape, block))
        if k == "pos":
            out[k] = torch.full(shape, sp.seq_len - 1, dtype=dtype)
        elif dtype.is_floating_point:
            out[k] = torch.randn(shape, generator=gen).to(dtype)
        else:
            out[k] = torch.randint(0, model.cfg.vocab, shape, generator=gen,
                                   dtype=dtype)
    return out


def run_program(model: Model, sp: ShapeSpec, ranks: ProcessRanks,
                dp: Sequence[str], *, zero1: bool = True,
                master: bool = False, seed: int = 0) -> Dict[str, Any]:
    """One process's program of a cell on ``ranks``, measured: its state
    set up (random weights from ``seed``), then one step of ``sp.kind``
    with its FLOPs counted, its collectives logged, the bytes alive
    tracked (the state's included) and K1's calls counted. The same
    function runs traced (:func:`trace`) and on real tensors over a real
    process group (the checks hold the two equal). Returns ``{"flops",
    "flops_by_op", "log", "counts", "peak_live_bytes",
    "state_live_bytes", "k1_calls"}``."""
    dp = tuple(dp)
    gen = torch.Generator().manual_seed(seed)
    live = LiveBytes()
    k1: List[int] = []
    with live:
        if sp.kind == "train":
            params, opt = init_train_state(model, gen, ranks=ranks,
                                           master=master, zero1=zero1)
            step, _ = jit_train_step(model, AdamWConfig(), ranks,
                                     batch_specs=model.batch_specs(sp, dp),
                                     dp_axes=dp, zero1=zero1)
            batch = _inputs(model, sp, gen)
            run = lambda: step(params, opt, batch)            # noqa: E731
        else:
            params = model.init(gen, ranks=ranks)
            batch = _inputs(model, sp, gen, ranks,
                            model.batch_specs(sp, dp))
            if sp.kind == "prefill":
                run = lambda: model.prefill(                  # noqa: E731
                    params, batch, None, ranks=ranks, dp_axes=dp)
            else:
                caches = model.init_caches(sp.global_batch, sp.seq_len,
                                           ranks=ranks, dp_axes=dp)
                run = lambda: model.decode_step(              # noqa: E731
                    params, caches, batch, ranks=ranks, dp_axes=dp)
        gc.collect()
        live.reset()
        state_bytes = live.current
        ranks.log = []
        ranks.collectives.clear()
        with counting_k1(k1), FlopCounterMode(display=False) as flops:
            out = run()
        del out
        gc.collect()
    log, ranks.log = ranks.log, None
    by_op = {str(k): int(v) for k, v in
             flops.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(flops.get_total_flops()), "flops_by_op": by_op,
            "log": log, "counts": dict(ranks.collectives),
            "peak_live_bytes": live.peak, "state_live_bytes": state_bytes,
            "k1_calls": len(k1)}


def group_ranks(shape: Sequence[int], axes: Sequence[str],
                names: Sequence[str], rank: int) -> List[int]:
    """The ranks of ``rank``'s group over the axes ``names`` of the grid."""
    me = grid_coords(shape, rank)
    fixed = [k for k, a in enumerate(axes) if a not in names]
    return [q for q in range(math.prod(shape))
            if all(grid_coords(shape, q)[k] == me[k] for k in fixed)]


def link_bytes_per_s(shape: Sequence[int], axes: Sequence[str],
                     names: Sequence[str], rank: int = 0) -> float:
    """NVLink's rate for a group inside one node of
    :data:`CARDS_PER_NODE` cards, else InfiniBand's."""
    nodes = {q // CARDS_PER_NODE
             for q in group_ranks(shape, axes, names, rank)}
    return NVLINK_BW if len(nodes) == 1 else IB_BW


def collective_terms(log: Sequence[Mapping], shape: Sequence[int],
                     axes: Sequence[str], rank: int = 0) -> Dict[str, Any]:
    """A step's :attr:`ProcessRanks.log` as the JAX dry run counts
    collectives, and its time on the links.

    The log holds the bytes of the last tensor handed to each call:
    ``psum``/``pmax`` the reduced tensor, ``all_gather`` its input block,
    ``reduce_scatter`` and ``all_to_all`` their input. The JAX dry run
    counts each collective's result: so an all-reduce is its tensor
    twice (a ring's reduce-scatter and all-gather on the wire), an
    all-gather its block times the group's size, a reduce-scatter its
    input over the group's size, an all-to-all its input (the result's
    size). Each call's converted bytes take the rate of its group
    (:func:`link_bytes_per_s`). Returns ``{"bytes": by JAX op,
    "calls": {"<op> over <axes>": {"calls", "bytes"}} (the logged bytes),
    "seconds"}``."""
    size = dict(zip(axes, shape))
    out = {k: 0 for k in _COLLECTIVE_OPS}
    calls: Dict[str, Dict[str, int]] = {}
    seconds = 0.0
    rates: Dict[Tuple[str, ...], float] = {}
    for e in log:
        names = tuple(e["axes"])
        n = e["bytes"]
        group = math.prod(size[a] for a in names)
        op = _JAX_OP.get(e["op"])
        if op is None:
            raise ValueError(f"no JAX op for the collective {e['op']!r}")
        result = {"all-reduce": 2 * n, "all-gather": n * group,
                  "reduce-scatter": n // group, "all-to-all": n}[op]
        out[op] += result
        if names not in rates:
            rates[names] = link_bytes_per_s(shape, axes, names, rank)
        seconds += result / rates[names]
        c = calls.setdefault(f"{e['op']} over {','.join(names)}",
                             {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += n
    return {"bytes": out, "calls": calls, "seconds": seconds}


@contextlib.contextmanager
def fake_grid(shape: Sequence[int], axes: Sequence[str]):
    """A :class:`ProcessRanks` of rank 0 on a grid of ``shape`` over a
    ``fake`` process group of its world size, its tensors on the CPU,
    inside ``FakeTensorMode``. The default process group is this
    process's for the block: use it in a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a fake grid needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        ranks = ProcessRanks(shape, axes, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield ranks
    finally:
        dist.destroy_process_group()


def trace(cfg: ModelConfig, sp: ShapeSpec, shape: Sequence[int],
          axes: Sequence[str], *, zero1: bool = True, master: bool = False
          ) -> Dict[str, Any]:
    """:func:`run_program` of rank 0 traced on a fake grid (see
    :func:`fake_grid`: in a process of its own), with its collectives'
    terms (:func:`collective_terms`)."""
    with fake_grid(shape, axes) as ranks:
        got = run_program(build(cfg), sp, ranks, dp_axes_of(ranks),
                          zero1=zero1, master=master)
    got["collectives"] = collective_terms(got["log"], shape, axes)
    return got


def skip_reason(cfg: ModelConfig, shape_name: str, grid: Grid
                ) -> Optional[str]:
    """Why the port does not run a cell, or None."""
    if shape_name not in cfg.runnable_shapes():
        return LONG_CONTEXT_SKIP
    try:
        check_grid_layout(cfg, grid.sizes.get("model", 1))
    except ValueError as e:
        return f"{e} ({LAYOUT_WAITS})"
    return None


def _skipped(arch: str, shape_name: str, multi_pod: bool, reason: str
             ) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "mesh_shape": make_production_mesh(multi_pod=multi_pod).sizes,
            "skipped": reason}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               zero1: bool = True, cfg_override: Optional[ModelConfig] = None,
               bf16_params: bool = False) -> Dict[str, Any]:
    """One cell's result (the JSON's dict): traced on the production grid
    in this process, which must hold no process group."""
    cfg = cfg_override or get_config(arch)
    grid = make_production_mesh(multi_pod=multi_pod)
    mesh = "multi" if multi_pod else "single"
    sp = SHAPES[shape_name]
    reason = skip_reason(cfg, shape_name, grid)
    if reason is not None:
        return _skipped(arch, shape_name, multi_pod, reason)
    t0 = time.time()
    got = trace(cfg, sp, grid.shape, grid.axes, zero1=zero1,
                master=bf16_params)
    trace_s = time.time() - t0
    chips = math.prod(grid.shape)
    cols = analytic_columns(cfg, sp, grid, zero1, bf16_params)
    coll = got["collectives"]
    flops = float(got["flops"])
    mf_dev = cols["model_flops_per_device"]
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": cols["analytic_hbm_bytes_per_device"] / HBM_BW,
             "collective_s": coll["seconds"]}
    step_s = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "mesh_shape": grid.sizes, "chips": chips, "kind": sp.kind,
        "process_rank": 0, "trace_s": round(trace_s, 2),
        "zero1": zero1, "bf16_params": bf16_params,
        "scan_corrected": False,
        "counted_flops_per_device": flops,
        "counted_flops_by_op": got["flops_by_op"],
        "analytic_hbm_bytes_per_device":
            cols["analytic_hbm_bytes_per_device"],
        "collective_bytes_per_device": coll["bytes"],
        "collective_total_per_device": float(sum(coll["bytes"].values())),
        "collective_calls": coll["calls"],
        "state_bytes_per_device": cols["state_bytes_per_device"],
        "state_live_bytes_per_device": got["state_live_bytes"],
        "peak_live_bytes_per_device": got["peak_live_bytes"],
        "peak_live_share_of_hbm": got["peak_live_bytes"] / HBM_BYTES,
        "kernel_calls": {"K1 partition_rank": got["k1_calls"]},
        "moe_active_fraction": cols["moe_active_fraction"],
        "model_flops_global": cols["model_flops_global"],
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": mf_dev / flops if flops else None,
        "roofline": dict(terms, dominant=max(terms, key=terms.get),
                         step_time_s=step_s,
                         mfu_bound=(mf_dev / PEAK_FLOPS) / max(step_s,
                                                               1e-12)),
        "hardware": HARDWARE,
    }


# -- the command line ---------------------------------------------------------


def _tag(arch: str, shape: str, multi: bool) -> str:
    return f"{arch}__{shape}__{'multi' if multi else 'single'}"


def _child(arch: str, shape: str, multi: bool, path: str,
           args: argparse.Namespace) -> subprocess.Popen:
    """One cell traced by a process of its own, which writes ``path``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "multi" if multi else "single",
           "--here", path]
    if args.no_zero1:
        cmd.append("--no-zero1")
    if args.bf16_params:
        cmd.append("--bf16-params")
    with open(path + ".log", "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _write(path: str, res: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1)
    os.replace(tmp, path)


def _report(tag: str, res: Dict[str, Any]) -> bool:
    """Print the cell's line; whether it failed."""
    if "roofline" in res:
        r = res["roofline"]
        print(f"[ok] {tag} trace={res['trace_s']}s dominant={r['dominant']} "
              f"step={r['step_time_s']:.4f}s", flush=True)
        return False
    if "skipped" in res:
        print(f"[skipped] {tag}: {res['skipped']}", flush=True)
        return False
    print(f"[FAIL] {tag}: {res.get('error')}", flush=True)
    return True


def table(out_dir: str) -> str:
    """The cells' JSONs in ``out_dir`` as a markdown table, one row an
    (arch, shape) with its ``single / multi`` grids' numbers, then the
    skipped cells with their reasons."""
    cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(pair, fmt) -> str:
        return " / ".join(fmt(pair[m]) for m in ("single", "multi")
                          if m in pair)

    rows, skipped = [], []
    for (arch, shape), pair in sorted(cells.items()):
        if not all("roofline" in r for r in pair.values()):
            for mesh, r in sorted(pair.items()):
                skipped.append(f"- {arch} {shape} {mesh}: "
                               f"{r.get('skipped') or 'ERROR ' + r['error']}")
            continue
        rows.append("| " + " | ".join([
            arch, shape,
            both(pair, lambda r: f"{r['counted_flops_per_device']:.4g}"),
            both(pair, lambda r: f"{r['peak_live_bytes_per_device'] / 1e9:.2f}"
                 f" ({r['peak_live_share_of_hbm']:.0%})"),
            both(pair, lambda r: f"{r['collective_total_per_device']:.3g}"),
            both(pair, lambda r: r["roofline"]["dominant"][:-2]),
            both(pair, lambda r: f"{r['roofline']['step_time_s']:.4g}"),
            both(pair, lambda r: f"{r['roofline']['mfu_bound']:.2%}")]) + " |")
    head = ("| arch | shape | counted FLOPs a device | peak live GB (of 80) "
            "| collective bytes a device | dominant | step bound s "
            "| mfu_bound |\n|---|---|---|---|---|---|---|---|")
    return "\n".join([head] + rows + [""] + skipped)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 params + fp32 master in optimizer")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the JSONs in --out as a markdown table")
    ap.add_argument("--here", metavar="PATH", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.table:
        print(table(args.out))
        return

    if args.here:             # one cell, traced in this process
        try:
            res = lower_cell(args.arch, args.shape, args.mesh == "multi",
                             zero1=not args.no_zero1,
                             bf16_params=args.bf16_params)
        except Exception as e:
            res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                   "error": f"{type(e).__name__}: {e}"}
        _write(args.here, res)
        sys.exit(1 if "error" in res else 0)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, mp) for mp in meshes]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    pending = []
    for arch, shape, mp in cells:
        tag = _tag(arch, shape, mp)
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip-cached] {tag}", flush=True)
            continue
        reason = skip_reason(get_config(arch), shape,
                             make_production_mesh(multi_pod=mp))
        if reason is None:
            pending.append((tag, arch, shape, mp, path))
            continue
        res = _skipped(arch, shape, mp, reason)
        _write(path, res)
        _report(tag, res)
    running: List[Tuple[str, str, subprocess.Popen]] = []
    while pending or running:
        while pending and len(running) < CELLS_AT_ONCE:
            tag, arch, shape, mp, path = pending.pop(0)
            print(f"[trace] {tag} ...", flush=True)
            running.append((tag, path, _child(arch, shape, mp, path, args)))
        tag, path, proc = running.pop(0)
        proc.wait()
        with open(path + ".log") as f:
            text = f.read()
        os.remove(path + ".log")
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        else:
            res = {"arch": tag.split("__")[0], "shape": tag.split("__")[1],
                   "mesh": tag.split("__")[2],
                   "error": f"exit code {proc.returncode}: "
                            f"{text.strip()[-2000:]}"}
            _write(path, res)
        failures += _report(tag, res)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
