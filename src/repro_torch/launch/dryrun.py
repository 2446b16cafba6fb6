"""Dry run on the meta device: every (arch x case x layout) cell at full
width, with no card and no allocation (counterpart of
``repro.launch.dryrun``).

JAX lowers and compiles each cell for a 512-device TPU mesh and reads the
compiled program.  Here each (arch, case) is traced once, on meta
tensors, through the port's own step: a train step (``make_train_step``
with AdamW, remat, bf16 gradients), a prefill or a decode step, as JAX's
``build_step`` picks.  The trace counts every matmul's FLOPs (the
formulas ``torch.utils.flop_counter.FlopCounterMode`` counts by) and
every op's operand and result bytes, each under the param leaf it reads;
the kernel wrappers record their calls' shapes instead of running
(``kernels/meta.py``), and ``analysis.roofline.kernel_call_cost``
reckons their FLOPs and bytes.  Each layout's per-device numbers then
come from that one trace and the sharding rules, never from another
trace:

* an op that reads a param leaf is split as the layout splits that leaf
  (``resolve_pspec`` over the ``model`` axis for the training layouts,
  ``serve_pspec`` for a column-only pod; a replicated leaf's work is
  whole on every device), and by the batch over ``data``;
* a kernel call is split by the batch over ``data`` and by its heads
  where the rules split them;
* every other matmul (activation products, the weight gradients) is
  split as the step's weight work is on average, and by the batch; every
  other op's bytes by the batch alone.

A cell also reckons the bytes a device holds (params, AdamW's f32
moments, the cache, the inputs; temporaries are not reckoned on meta),
whether they fit a card's 80 GB, the collective bytes (a pod's column
gathers from its members' widths; a training layout's tensor-parallel
all-reduces and data-parallel gradient all-reduce), ``model_flops``,
``kernel_hbm_bytes`` and the roofline terms on H100s.  The fit table
gives, for every config, the fewest members of a column-only pod whose
member holds its weights and an 8-slot x 1024-row pool within a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \
      --case train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.roofline import (kernel_call_cost,
                                           kernel_hbm_bytes, model_flops,
                                           roofline_terms)
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed.sharding import (SERVE_AXIS, TPGroup,
                                              cache_pspec, resolve_pspec,
                                              serve_pspec, shard_put)
from repro_torch.kernels import meta
from repro_torch.launch.mesh import (HBM_BYTES, MESH_LAYOUTS, POD_LAYOUTS,
                                     POD_SIZES, n_cards)
from repro_torch.models import SHAPE_CASES, Model, build_model, input_specs
from repro_torch.models.model import PodModel
from repro_torch.serving.engine import context_refusal
from repro_torch.training import AdamW, TrainStepConfig, make_train_step

# Cells skipped by design (repro/launch/dryrun.py:45-48): pure
# full-attention archs do not run the long-context decode cell.
LONG_CTX_SKIPS = {
    "qwen2-7b", "starcoder2-15b", "qwen1.5-110b", "seamless-m4t-large-v2",
    "llama-3.2-vision-11b", "qwen2-moe-a2.7b",
}

SERVE_SLOTS, SERVE_LEN = 8, 1024  # the fit table's pool (the smoke's)

TEMPORARIES = "not reckoned on meta"


# --------------------------------------------------------------------------
# Meta params and the trace
# --------------------------------------------------------------------------


def _walk(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _walk(sub, f"{path}/{key}" if path else key)
    else:
        yield path, tree


def _at(tree: Any, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def meta_params(model: Model) -> dict:
    """Empty meta leaves of the model's specs, each in its dtype."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return walk(model.specs)


@dataclasses.dataclass
class Tally:
    """One trace's counts: (FLOPs, bytes) under each param leaf it read,
    of the matmuls that read none, and of every other op, plus the kernel
    calls recorded on meta."""

    by_leaf: dict[str, list[float]]
    matmul: list[float]
    other: list[float]
    calls: list[meta.KernelCall]
    seconds: float = 0.0

    @property
    def flops(self) -> float:
        return (sum(f for f, _ in self.by_leaf.values()) + self.matmul[0]
                + self.other[0])


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
# Ops besides the views whose output holds the input's values (a cast, a
# copy): the output stays the param leaf's.
_CARRY = {"_to_copy", "clone", "_unsafe_view"}


class _Count(TorchDispatchMode):
    """Counts each op's FLOPs (``flop_registry``, the FlopCounterMode
    formulas) and operand plus result bytes under the param leaf it reads
    (``leaf_of``: a tensor -> its leaf's path, carried through views and
    casts)."""

    def __init__(self, leaf_of: WeakIdKeyDictionary, tally: Tally):
        super().__init__()
        self.leaf_of, self.tally = leaf_of, tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__.rstrip("_")
        ins = list(_tensors((args, kwargs)))
        leaf = next((self.leaf_of[t] for t in ins if t in self.leaf_of),
                    None)
        outs = list(_tensors(out))
        if leaf is not None and (func.is_view or name in _CARRY):
            for t in outs:
                self.leaf_of[t] = leaf
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        nbytes = 0.0
        if not func.is_view and name not in _ALLOC:
            nbytes = float(sum(t.numel() * t.element_size()
                               for t in (*ins, *outs)))
        if leaf is not None:
            acc = self.tally.by_leaf.setdefault(leaf, [0.0, 0.0])
        else:
            acc = self.tally.matmul if flops else self.tally.other
        acc[0] += flops
        acc[1] += nbytes
        return out


def step_thunk(model: Model, case, params: dict, specs: dict):
    """The cell's step on ``params`` and the inputs ``specs``
    (``input_specs``' tree) as a thunk (JAX's ``build_step``)."""
    if case.kind == "train":
        opt = AdamW()
        state = opt.init(params)
        # bf16 gradient accumulation, as JAX's dry run ships it.
        step = make_train_step(model, opt, TrainStepConfig(
            remat=True, grad_compress=True))
        return lambda: step(params, state, specs)
    if case.kind == "prefill":
        def prefill():
            with torch.no_grad():
                return model.prefill(params, specs["tokens"],
                                     max_len=case.seq_len,
                                     ctx=specs.get("ctx"))
        return prefill

    def decode():
        with torch.no_grad():
            return model.decode_step(params, specs["token"], specs["cache"])
    return decode


def trace(model: Model, case) -> Tally:
    """Trace the cell's step once on the meta device and count it."""
    params = meta_params(model)
    leaf_of = WeakIdKeyDictionary()
    for path, leaf in _walk(params):
        leaf_of[leaf] = path
    run = step_thunk(model, case, params, input_specs(model, case)[0])
    tally = Tally({}, [0.0, 0.0], [0.0, 0.0], [])
    t0 = time.perf_counter()
    with meta.recording() as calls, _Count(leaf_of, tally):
        run()
    tally.calls = calls
    tally.seconds = time.perf_counter() - t0
    return tally


# --------------------------------------------------------------------------
# Per-device reckoning under a layout
# --------------------------------------------------------------------------


def _is_pod(axis_sizes: dict[str, int]) -> bool:
    return SERVE_AXIS in axis_sizes


def _nbytes_of(shape, spec, sizes, itemsize) -> float:
    n = 1
    for d, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= d // math.prod(sizes[a] for a in axes)
    return float(n * itemsize)


def _share(shape, spec, sizes) -> float:
    return _nbytes_of(shape, spec, sizes, 1) / max(math.prod(shape), 1)


def _batch_share(batch: int, sizes: dict[str, int]) -> float:
    return _share((batch,), resolve_pspec(("batch",), (batch,), sizes),
                  sizes)


def _compute_sizes(sizes: dict[str, int]) -> dict[str, int]:
    """The axes that split a weight's work: a pod's ``serve`` axis, or a
    training layout's ``model`` axis (``data`` shards params for storage
    only, FSDP-style, and splits the batch)."""
    return ({SERVE_AXIS: sizes[SERVE_AXIS]} if _is_pod(sizes)
            else {"model": sizes.get("model", 1)})


def _resolver(sizes):
    return serve_pspec if _is_pod(sizes) else resolve_pspec


def leaf_shares(model: Model, sizes: dict[str, int]) -> dict[str, float]:
    """Each param leaf's share of its work a device does under ``sizes``."""
    csizes, resolve = _compute_sizes(sizes), _resolver(sizes)
    names = model.param_names()
    return {path: _share(spec.shape, resolve(_at(names, path), spec.shape,
                                              csizes), csizes)
            for path, spec in _walk(model.specs)}


def _call_share(call: meta.KernelCall, sizes: dict[str, int]) -> float:
    """A kernel call's share a device: its batch over ``data`` and its
    heads (kv heads for attention) where the rules split them."""
    csizes = _compute_sizes(sizes)
    shape = call.reads[0][0]
    batch, heads = shape[0], shape[2]
    if "attention" in call.name:
        heads, name = call.reads[1][0][2], "kv_heads"
    else:
        name = "heads"
    split = _share((heads,), resolve_pspec((name,), (heads,), csizes),
                   csizes)
    return _batch_share(batch, sizes) * split


def per_device(model: Model, case, tally: Tally, sizes: dict[str, int]
               ) -> dict[str, float]:
    """Counted FLOPs and bytes a device does under ``sizes``, from the one
    trace and the sharding rules."""
    bshare = _batch_share(case.global_batch, sizes)
    shares = leaf_shares(model, sizes)
    w_flops = sum(f for f, _ in tally.by_leaf.values())
    w_share = (sum(f * shares[leaf] for leaf, (f, _) in tally.by_leaf.items())
               / w_flops if w_flops else 1.0)
    flops = (sum(f * shares[leaf] for leaf, (f, _) in tally.by_leaf.items())
             * bshare + (tally.matmul[0] + tally.other[0]) * w_share * bshare)
    nbytes = (sum(b * shares[leaf] for leaf, (_, b) in tally.by_leaf.items())
              * bshare + tally.matmul[1] * w_share * bshare
              + tally.other[1] * bshare)
    k_flops = k_bytes = 0.0
    for call in tally.calls:
        f, b = kernel_call_cost(call)
        s = _call_share(call, sizes)
        k_flops += f * s
        k_bytes += b * s
    return dict(flops=flops, nbytes=nbytes, kernel_flops=k_flops,
                kernel_bytes=k_bytes)


def held_bytes(model: Model, case, sizes: dict[str, int]) -> dict[str, int]:
    """Bytes a device holds under ``sizes``: params, AdamW's f32 moments
    and step (train), the cache (prefill's output, decode's input), the
    inputs."""
    resolve = _resolver(sizes)
    names = model.param_names()
    params = opt = 0.0
    for path, spec in _walk(model.specs):
        pspec = resolve(_at(names, path), spec.shape, sizes)
        params += _nbytes_of(spec.shape, pspec, sizes, spec.dtype.itemsize)
        opt += 2 * _nbytes_of(spec.shape, pspec, sizes, 4)
    specs, in_names = input_specs(model, case)
    b, s = case.global_batch, case.seq_len
    if case.kind == "prefill":
        cache = {k: torch.empty(shape, dtype=dt, device="meta")
                 for k, (shape, dt) in model.cache_specs(b, s).items()}
        cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
        cache_names = model.cache_names(b, s)
    else:
        cache = specs.pop("cache", {})
        cache_names = in_names.pop("cache", {})
    held_cache = 0.0
    for key, t in cache.items():
        nm = cache_names[key]
        if _is_pod(sizes):
            spec = resolve_pspec(nm, t.shape, sizes)
        elif "seq" in nm and "batch" in nm:
            spec = cache_pspec(t.shape, sizes, nm)
        else:
            spec = resolve_pspec(nm, t.shape, sizes)
        held_cache += _nbytes_of(t.shape, spec, sizes, t.element_size())
    inputs = 0.0
    for key, t in specs.items():
        spec = (resolve_pspec(in_names[key], t.shape, sizes)
                if not _is_pod(sizes) else (None,) * t.dim())
        inputs += _nbytes_of(t.shape, spec, sizes, t.element_size())
    out = dict(params=int(params),
               optimizer=int(opt + 4) if case.kind == "train" else 0,
               cache=int(held_cache), inputs=int(inputs))
    out["total"] = sum(out.values())
    return out


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------


def _col(width: int, n: int) -> int:
    """A column-split product's gathered width (0 where serve_pspec keeps
    the leaf whole)."""
    return width if width % n == 0 else 0


def pod_gather_bytes(cfg, n: int, rows: int, logit_rows: int
                     ) -> dict[str, float]:
    """Bytes a member of an ``n``-member column-only pod receives in one
    step's gathers of ``rows`` tokens: each gather brings the other
    members' (n-1)/n of a column-split result's width (bf16), and the
    primary gathers the f32 logits of ``logit_rows`` rows.  Per layer:
    the attention output where a member holds its kv heads, else q, k
    and v; the FFN's activation (the moe experts' buckets at the serving
    capacity factor, and the shared experts'); rwkv's mixer outputs and
    channel keys; the hybrid's scan and attention halves."""
    if n <= 1:
        return {}
    frac = (n - 1) / n
    q, kv = cfg.q_dim, cfg.kv_dim
    attn = _col(q, n) if cfg.n_kv_heads % n == 0 else (
        _col(q, n) + 2 * _col(kv, n))
    per_row = 0.0
    extra = 0.0  # rows that are not tokens (the moe buckets)
    if cfg.family in ("dense", "vlm", "encdec"):
        per_row = attn + _col(cfg.d_ff, n)
    elif cfg.family == "moe":
        from repro_torch.models.moe import _capacity
        fe = cfg.moe_d_ff or cfg.d_ff
        cap = _capacity(rows, cfg, cfg.moe_cf_eval)
        per_row = attn + _col(cfg.n_shared_experts * fe, n)
        extra = cfg.n_experts * cap * _col(fe, n)
    elif cfg.family == "rwkv":
        d, h = cfg.d_model, cfg.d_model // 64
        per_row = (_col(d, n) if h % n == 0 else 4 * _col(d, n)) + _col(
            cfg.d_ff, n)
    elif cfg.family == "hybrid":
        per_row = _col(cfg.n_heads * cfg.dh, n) + attn + _col(cfg.d_ff, n)
    layers = cfg.n_layers + getattr(cfg, "encoder_layers", 0)
    gathers = frac * 2.0 * layers * (per_row * rows + extra)
    logits = frac * 4.0 * logit_rows * _col(cfg.padded_vocab, n)
    return {"all-gather": gathers, "logits": logits}


def mesh_collective_bytes(model: Model, case, sizes: dict[str, int]
                          ) -> dict[str, float]:
    """Bytes a device sends a step under a training layout, ring cost:
    two tensor-parallel all-reduces of the hidden state a layer (after
    the attention's and the FFN's row-split products; again in the
    backward, and once more in the remat's recompute), and in training
    the data-parallel all-reduce of the device's bf16 gradients."""
    cfg = model.cfg
    m, d = sizes.get("model", 1), sizes.get("data", 1)
    out = {}
    rows = case.global_batch * (1 if case.kind == "decode" else case.seq_len)
    rows *= _batch_share(case.global_batch, sizes)
    layers = cfg.n_layers + getattr(cfg, "encoder_layers", 0)
    if m > 1:
        passes = 3 if case.kind == "train" else 1
        out["all-reduce (tp)"] = (2.0 * (m - 1) / m * 2 * layers * passes
                                  * rows * cfg.d_model * 2.0)
    if d > 1 and case.kind == "train":
        shares = leaf_shares(model, sizes)
        grads = sum(math.prod(spec.shape) * shares[path] * 2.0
                    for path, spec in _walk(model.specs))
        out["all-reduce (dp)"] = 2.0 * (d - 1) / d * grads
    return out


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CellResult:
    """JAX's ``CellResult`` fields in the port's meanings: ``mesh`` names
    the layout; ``flops_per_device`` / ``bytes_per_device`` are the
    trace's counts a device (the kernels' left out), and
    ``hlo_flops_per_device`` / ``hbm_bytes_per_device`` add the kernels'
    reckoned FLOPs and bytes; ``memory`` holds the bytes a device holds;
    ``kernel_internal_bytes`` is 0 (a kernel computes nothing on meta)."""

    arch: str
    case: str
    mesh: str
    status: str  # ok | skipped | failed
    seconds: float = 0.0
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_bytes: float = 0.0
    memory: dict = dataclasses.field(default_factory=dict)
    hlo_flops_per_device: float = 0.0
    hbm_bytes_per_device: float = 0.0
    kernel_internal_bytes: float = 0.0
    collective_wire: dict = dataclasses.field(default_factory=dict)
    model_flops: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_adj_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    mfu_bound: float = 0.0
    error: str = ""
    # the port's own fields
    layout: dict = dataclasses.field(default_factory=dict)
    n_cards: int = 1
    kernel_flops_per_device: float = 0.0
    kernel_bytes_per_device: float = 0.0
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    temporaries: str = TEMPORARIES
    fits: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def layouts_for(case) -> dict[str, dict[str, int]]:
    """The training layouts for every case; the serving pods for a
    prefill or decode."""
    out = dict(MESH_LAYOUTS)
    if case.kind != "train":
        out.update(POD_LAYOUTS)
    return out


def skip_reason(arch: str, case_name: str, cfg, sizes) -> Optional[str]:
    if case_name == "long_500k" and arch in LONG_CTX_SKIPS:
        return "pure full-attention arch (repro/launch/dryrun.py:45-48)"
    if _is_pod(sizes) and sizes[SERVE_AXIS] > 1:
        return context_refusal(cfg)
    return None


def cell(arch: str, case_name: str, layout: str, model: Model,
         tally: Tally) -> CellResult:
    """One cell's result from its (arch, case)'s trace."""
    case = SHAPE_CASES[case_name]
    sizes = layouts_for(case)[layout]
    n = n_cards(sizes)
    t0 = time.perf_counter()
    cfg = model.cfg
    dev = per_device(model, case, tally, sizes)
    memory = held_bytes(model, case, sizes)
    if _is_pod(sizes):
        rows = case.global_batch * (1 if case.kind == "decode"
                                    else case.seq_len)
        coll = pod_gather_bytes(cfg, n, rows, case.global_batch)
    else:
        coll = mesh_collective_bytes(model, case, sizes)
    mf = model_flops(cfg, case)
    kb = kernel_hbm_bytes(cfg, case)
    flops = dev["flops"] + dev["kernel_flops"]
    rl = roofline_terms(flops, dev["nbytes"], sum(coll.values()), n, mf,
                        kernel_bytes_global=kb)
    calls: dict[str, int] = {}
    for call in tally.calls:
        calls[call.name] = calls.get(call.name, 0) + 1
    return CellResult(
        arch=arch, case=case_name, mesh=layout, status="ok",
        seconds=tally.seconds + time.perf_counter() - t0,
        flops_per_device=dev["flops"], bytes_per_device=dev["nbytes"],
        collectives=coll, collective_bytes=sum(coll.values()),
        memory=memory, hlo_flops_per_device=flops,
        hbm_bytes_per_device=dev["nbytes"] + dev["kernel_bytes"],
        collective_wire=dict(coll), model_flops=mf,
        compute_s=rl.compute_s, memory_s=rl.memory_s,
        memory_adj_s=rl.memory_adj_s, collective_s=rl.collective_s,
        dominant=rl.dominant, useful_ratio=rl.useful_ratio,
        mfu_bound=rl.mfu_bound, layout=dict(sizes), n_cards=n,
        kernel_flops_per_device=dev["kernel_flops"],
        kernel_bytes_per_device=dev["kernel_bytes"], kernel_calls=calls,
        fits=memory["total"] <= HBM_BYTES)


def run_cells(arch: str, case_name: str, *, reduced: bool = False
              ) -> list[CellResult]:
    """Every layout's cell of (arch, case), from one trace."""
    case = SHAPE_CASES[case_name]
    cfg = get_config(arch, reduced=reduced)
    layouts = layouts_for(case)
    out, todo = [], {}
    for name, sizes in layouts.items():
        why = skip_reason(arch, case_name, cfg, sizes)
        if why:
            out.append(CellResult(arch, case_name, name, "skipped",
                                  error=why, layout=dict(sizes),
                                  n_cards=n_cards(sizes)))
        else:
            todo[name] = sizes
    if not todo:
        return out
    t0 = time.perf_counter()
    try:
        model = build_model(cfg)
        tally = trace(model, case)
        out += [cell(arch, case_name, name, model, tally) for name in todo]
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        err = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=8)}"
        out += [CellResult(arch, case_name, name, "failed",
                           seconds=time.perf_counter() - t0, error=err,
                           layout=dict(sizes), n_cards=n_cards(sizes))
                for name, sizes in todo.items()]
    order = list(layouts)
    return sorted(out, key=lambda r: order.index(r.mesh))


# --------------------------------------------------------------------------
# Serving pods: a member's bytes and the fit table
# --------------------------------------------------------------------------


def serve_member_bytes(cfg, shards: int, n_slots: int = SERVE_SLOTS,
                       max_len: int = SERVE_LEN, kv_int8: bool = False
                       ) -> tuple[int, int]:
    """(weight bytes, slot-pool bytes) one member of a ``shards``-member
    column-only pod holds, on the meta device through the port's own pod
    code: the weights as ``shard_put`` places them by ``serve_pspec``, the
    pool as ``PodModel.init_slot_cache`` makes it (per-slot ``pos``
    included); ``shards=1`` is one instance's."""
    from repro_torch.core.model_sharing import pytree_nbytes
    model = build_model(cfg)
    params = meta_params(model)
    if shards == 1:
        pool = model.init_slot_cache(n_slots, max_len, "meta", kv_int8)
        return pytree_nbytes(params), pytree_nbytes(pool)
    meta_dev = torch.device("meta")
    group = TPGroup((meta_dev,) * shards, tuple(range(shards)))
    member = shard_put(params, model.param_names(), group, serve_pspec)[0]
    pool = PodModel(model, group, kv_int8).init_slot_cache(
        n_slots, max_len)[0]
    return pytree_nbytes(member), pytree_nbytes(pool)


def fit_table(archs: Optional[list[str]] = None) -> list[dict]:
    """For each config: its member bytes at 1, 2, 4 and 8 members (weights
    plus the 8 x 1024 pool) and the fewest members whose member fits a
    card (None: no pod of ``POD_SIZES`` fits, or the family is refused as
    a pod and one card does not hold it)."""
    rows = []
    for arch in archs or all_arch_ids():
        cfg = get_config(arch)
        members, fewest = {}, None
        refused = context_refusal(cfg) is not None
        for n in POD_SIZES:
            if refused and n > 1:
                break
            w, pool = serve_member_bytes(cfg, n)
            members[n] = (w, pool)
            if fewest is None and w + pool <= HBM_BYTES:
                fewest = n
        rows.append(dict(arch=arch, members=members, fewest=fewest,
                         refused_as_pod=refused))
    return rows


def format_fit_table(rows: list[dict]) -> str:
    head = (f"{'arch':24s} " + " ".join(f"{f'{n} member GB':>12s}"
                                         for n in POD_SIZES)
            + "  fewest that fit 80 GB")
    lines = [head]
    for r in rows:
        cols = " ".join(
            f"{(sum(r['members'][n]) / 1e9):12.2f}" if n in r["members"]
            else f"{'refused':>12s}" for n in POD_SIZES)
        fewest = r["fewest"] or ("none (context family, no pod)"
                                 if r["refused_as_pod"] else "none")
        lines.append(f"{r['arch']:24s} {cols}  {fewest}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _line(res: CellResult) -> str:
    tag = f"{res.arch}__{res.case}__{res.mesh}"
    return (f"[{res.status:7s}] {tag:44s} {res.seconds:6.2f}s "
            f"C={res.compute_s:.4f}s M={res.memory_adj_s:.4f}s "
            f"X={res.collective_s:.4f}s dom={res.dominant or '-'} "
            f"useful={res.useful_ratio:.2f} "
            f"held={res.memory.get('total', 0) / 1e9:.1f}GB"
            f"{' fits' if res.fits else ''}"
            + (f"  {res.error.splitlines()[0]}" if res.error else ""))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--case", default=None, choices=list(SHAPE_CASES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun",
                    help="directory of dryrun.jsonl, one line a cell")
    args = ap.parse_args(argv)

    archs = all_arch_ids() if args.all or not args.arch else [args.arch]
    cases = list(SHAPE_CASES) if args.all or not args.case else [args.case]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "dryrun.jsonl")
    failed = 0
    t0 = time.perf_counter()
    with open(path, "w") as f:
        for arch in archs:
            for case_name in cases:
                for res in run_cells(arch, case_name):
                    f.write(json.dumps(res.to_json()) + "\n")
                    failed += res.status == "failed"
                    print(_line(res), flush=True)
    print(f"\n[dryrun] {path}: {failed} failed, "
          f"{time.perf_counter() - t0:.1f}s")
    print("\n[fit] column-only pods, a member's weights + an "
          f"{SERVE_SLOTS}-slot x {SERVE_LEN}-row pool (bf16):")
    print(format_fit_table(fit_table(archs)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
