"""Three-term roofline from dry-run records, on the H100.

  compute    = flops / PEAK_FLOPS              (per rank: a record counts one
  memory     = bytes_accessed / HBM_BW          rank's share of the program)
  collective = Σ collective bytes / LINK_BW

The JAX package's ``repro.roofline.analysis`` with the H100's constants (see
below) and a second source of collective bytes. The reference parses them
from compiled HLO text (:func:`collective_bytes_from_hlo`, ported as it is,
so :func:`report` reads the reference's records too); the port's dry run
runs eagerly over DTensors, and :func:`make_comm_tally` tallies the collectives
the run issues (:func:`collectives_from_comm`), under the same keys, as
bytes a rank.

XLA counts a while-loop body once, so the reference multiplies its LM
records by the loop trips (:func:`loop_trips`). The port runs every layer
and microbatch, so its counts hold every trip already: its records carry
``"trips": 1`` and :func:`loop_trips` returns that.

:func:`make_op_tally` counts a rank's flops and bytes over the aten ops the run
issues (the conventions are in its docstring); :func:`hop_work` is the count
of one frontier hop that the GQ-Fast cells (whose hop kernels cannot run on
meta tensors) and ``chip_smoke.py``'s kernel bounds share.
"""
from __future__ import annotations

import contextvars
import functools
import json
import os
import re
from dataclasses import dataclass

# NVIDIA H100 SXM5 data sheet: dense BF16 tensor-core peak (989.4 TFLOP/s;
# the 1,979 figure assumes 2:4 sparsity) — the counterpart of the
# reference's TPU v5e bf16 peak.
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth, 3.35 TB/s (PERF.md §6 uses it).
HBM_BW = 3.35e12
# A 16-wide mesh axis cannot sit inside one 8-GPU NVLink node, so the
# collective term uses the per-GPU inter-node link: NDR InfiniBand at
# 400 Gb/s = 50 GB/s, one NIC a GPU as in a DGX H100.
LINK_BW = 50e9

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)|(?P<single>[a-z0-9_\[\],{}\s]*?))\s*"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _line_result_bytes(line: str, op: str) -> int:
    """Result tensor bytes of an HLO collective line: the shape(s) sit between
    '=' and the op name (``%ag = f32[2048,1,128]{2,1,0} all-gather(...)``);
    result size ≈ payload moved per device for ag/ar/rs/a2a/cp."""
    try:
        seg = line.split("=", 1)[1]
        seg = seg[: seg.index(op)]
    except (IndexError, ValueError):
        return 0
    total = 0
    for m in _SHAPE_RE.finditer(seg):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_from_hlo(hlo: str) -> dict[str, float]:
    """Per-collective-type byte totals from compiled HLO text (per device)."""
    out: dict[str, float] = {}
    for line in hlo.splitlines():
        s = line.strip()
        m = _COLL_RE.search(s)
        if not m:
            continue
        if "-done(" in s:
            continue  # async pairs: count the -start only
        op = m.group("op")
        b = _line_result_bytes(s, op)
        out[op] = out.get(op, 0.0) + b
    return out


# ---------------------------------------------------------------------------
# The port's tallies
# ---------------------------------------------------------------------------

_TALLIES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tallies", default=())


def hop_work(E: int, n_src: int, n_dst: int, dst_bytes: int, m_bytes: int,
             extra: int = 0, batch: int = 1) -> tuple[int, int]:
    """(bytes, operations) of one frontier hop over ``E`` edges: the src ids
    (4 B an edge), the dst and measure streams as stored, the ``batch``
    frontiers and outputs once each, and a multiply and a combine an edge a
    row."""
    return (4 * E + dst_bytes + m_bytes + 4 * batch * n_src + 4 * batch * n_dst + extra,
            2 * E * batch)


def count_work(flops: float = 0.0, nbytes: float = 0.0, collectives: dict | None = None) -> None:
    """Add work done without an op the tallies can see (a hop counted by
    :func:`hop_work`) to every active tally."""
    for t in _TALLIES.get():
        t.add_work(flops, nbytes, collectives or {})


# functional collectives → the reference's HLO names; the factor turns the
# local input's bytes into the result's, which is what the HLO count reads
_FUNCOL = {
    "all_gather_into_tensor": ("all-gather", "group"),
    "all_gather_into_tensor_coalesced": ("all-gather", "group"),
    "all_reduce": ("all-reduce", 1),
    "all_reduce_coalesced": ("all-reduce", 1),
    "reduce_scatter_tensor": ("reduce-scatter", "1/group"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "1/group"),
    "all_to_all_single": ("all-to-all", 1),
    "broadcast": ("collective-permute", 1),
    "shard_dim_alltoall": ("all-to-all", 1),
}
_FUNCOL_NS = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd", "_dtensor")

# ops that move no bytes: views and metadata queries
_NO_BYTES = {"detach", "alias", "lift_fresh", "size", "stride", "dim", "numel",
             "is_contiguous", "wait_tensor", "_local_scalar_dense"}


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t) -> int:
    """A tensor's bytes as it is read: its elements, but no more than its
    storage holds (a broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _group_size(func, args, kwargs) -> int:
    for a, arg in zip(func._schema.arguments, args):
        if a.name == "group_size":
            return int(arg)
    return int(kwargs["group_size"])


@functools.cache
def _tally_classes():
    """(OpTally, CommTally), built on first use (torch is imported then)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map
    from torch.utils.flop_counter import flop_registry

    class Tally(TorchDispatchMode):
        """A dispatch mode that :func:`count_work` reaches while active."""

        def __enter__(self):
            self._token = _TALLIES.set(_TALLIES.get() + (self,))
            return super().__enter__()

        def __exit__(self, *exc):
            _TALLIES.reset(self._token)
            return super().__exit__(*exc)

    class OpTally(Tally):
        """A rank's flops and bytes over the aten ops a program issues, above
        DTensor's dispatch:

        * flops are the matrix-product class that ``FlopCounterMode``
          counts (its formula registry: mm, bmm, addmm, baddbmm,
          convolutions, attention), a rank's share: an op on DTensors counts
          its global flops × its output's local over global elements ÷ the
          sizes of the mesh dims its output is ``Partial`` over (a
          replicated output is computed whole on every rank and counts
          whole);
        * bytes are each op's local inputs read once (no more than each
          input's storage) and its local outputs written once, over every op
          but views, metadata queries and collectives (those are the comm
          tally's): the eager program's traffic, an upper figure beside
          XLA's fused count.
        """

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0

        def add_work(self, flops, nbytes, collectives) -> None:
            self.flops += flops
            self.bytes += nbytes

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if isinstance(func, torch._ops.HigherOrderOperator) or func.namespace != "aten" \
                    or func._overloadpacket.__name__ in _NO_BYTES or func.is_view:
                return out
            outs = list(_tensors(out))
            if func._overloadpacket in flop_registry and outs:
                def shape(x):
                    return x.shape if isinstance(x, torch.Tensor) else x

                f = flop_registry[func._overloadpacket](
                    *tree_map(shape, args), **tree_map(shape, kwargs),
                    out_val=tree_map(shape, out))
                self.flops += f * _local_share(outs[0]) if isinstance(outs[0], DTensor) else f
            for t in _tensors((args, kwargs)):
                self.bytes += _nbytes(t._local_tensor if isinstance(t, DTensor) else t)
            for t in outs:
                lt = t._local_tensor if isinstance(t, DTensor) else t
                self.bytes += lt.numel() * lt.element_size()
            return out

    class CommTally(Tally):
        """Bytes a rank of the collectives a program issues, under the
        reference's HLO names. Below DTensor's dispatch (it lets DTensor
        desugar an op into local ops and collectives first, as
        ``CommDebugMode`` does), each functional collective counts its
        result's bytes, as the HLO count does."""

        def __init__(self):
            super().__init__()
            self.bytes_by_kind: dict[str, float] = {}

        def add_work(self, flops, nbytes, collectives) -> None:
            for k, v in collectives.items():
                self._add(k, v)

        def _add(self, kind: str, n: float) -> None:
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = func._overloadpacket.__name__
            if func.namespace in _FUNCOL_NS and name in _FUNCOL:
                kind, factor = _FUNCOL[name]
                n = sum(_nbytes(t) for t in _tensors(args[0]))
                if factor != 1:
                    size = _group_size(func, args, kwargs)
                    n = n * size if factor == "group" else n / size
                self._add(kind, n)
            return func(*args, **kwargs)

    return OpTally, CommTally


def make_op_tally():
    """A dispatch mode tallying a rank's flops and bytes (``OpTally``)."""
    return _tally_classes()[0]()


def make_comm_tally():
    """A dispatch mode tallying a rank's collective bytes (``CommTally``)."""
    return _tally_classes()[1]()


def collectives_from_comm(tally) -> dict[str, float]:
    """The collective bytes a rank of a :func:`make_comm_tally` tally, keyed
    as :func:`collective_bytes_from_hlo` keys them."""
    return dict(tally.bytes_by_kind)


def _local_share(t) -> float:
    """The share of a DTensor op's global work one rank does: local over
    global output elements, over the sizes of the mesh dims the output is
    ``Partial`` over."""
    from torch.distributed.tensor import Partial

    n = t.numel()
    share = t._local_tensor.numel() / n if n else 0.0
    for size, p in zip(tuple(t.device_mesh.shape), t.placements):
        if isinstance(p, Partial):
            share /= size
    return share


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.__getitem__)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def loop_trips(rec: dict) -> int:
    """The factor a record's counts are short of the program by. A port
    record carries ``trips`` (1: the eager run counts every layer and
    microbatch). The reference's records do not: XLA counts while-loop
    bodies ONCE, and its LM cells run scan-over-layers (×L) and
    grad-accumulation (×micro), corrected by the known outer trip counts
    (GNN/recsys/gqfast cells unroll — factor 1)."""
    if "trips" in rec:
        return int(rec["trips"])
    try:
        from ..configs.registry import get_arch

        arch = get_arch(rec["arch"])
        if arch.kind != "lm":
            return 1
        L = arch.full.n_layers
        if rec.get("kind") == "train":
            m = re.search(r"micro=(\d+)", rec.get("notes", ""))
            micro = int(m.group(1)) if m else 1
            return L * micro
        return L
    except Exception:  # noqa: BLE001 — an unknown arch has no loop to correct
        return 1


def roofline_from_record(rec: dict, chips: int = 256) -> Roofline:
    coll = sum(rec.get("collectives", {}).values())
    trips = loop_trips(rec)
    return Roofline(
        compute_s=rec.get("flops", 0.0) * trips / PEAK_FLOPS,
        memory_s=rec.get("bytes_accessed", 0.0) * trips / HBM_BW,
        collective_s=coll * trips / LINK_BW,
    )


def load_records(art_dir: str = "artifacts/dryrun") -> list[dict]:
    recs = []
    if not os.path.isdir(art_dir):
        return recs
    for name in sorted(os.listdir(art_dir)):
        if name.endswith(".json"):
            with open(os.path.join(art_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def _mesh_ranks(mesh: str) -> int:
    """Ranks of a record's mesh, from its name's sizes (``pod_16x16``)."""
    n = 1
    for d in re.findall(r"\d+", mesh.rsplit("_", 1)[-1]):
        n *= int(d)
    return n


def report(art_dir: str = "artifacts/dryrun", mesh: str | None = "pod_16x16") -> str:
    """Markdown roofline table over all recorded cells."""
    rows = []
    header = (
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | "
        "dominant | MODEL_FLOPS/HLO_FLOPs | bytes/dev | note |"
    )
    rows.append(header)
    rows.append("|" + "---|" * 10)
    for rec in load_records(art_dir):
        if mesh and rec.get("mesh") != mesh:
            continue
        if rec.get("variant"):
            continue  # perf variants are not the baseline table
        if rec["status"] == "skipped":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | — | — | — | "
                f"— | — | — | SKIP: {rec['reason'][:60]}… |"
            )
            continue
        if rec["status"] != "ok":
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | — | — | — | "
                f"— | — | — | ERROR: {rec['error'][:60]} |"
            )
            continue
        rl = roofline_from_record(rec)
        mf = rec.get("model_flops") or 0.0
        # model_flops is the GLOBAL estimate; a record's flops are per rank
        chips = _mesh_ranks(rec["mesh"])
        trips = loop_trips(rec)
        ratio = (mf / chips) / (rec["flops"] * trips) if rec.get("flops") else 0.0
        mem = rec.get("memory", {})
        dev_bytes = mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{rl.compute_s:.4f} | {rl.memory_s:.4f} | {rl.collective_s:.4f} | "
            f"**{rl.dominant}** | {ratio:.2f} | {dev_bytes/1e9:.2f} GB | {rec.get('notes','')} |"
        )
    return "\n".join(rows)


if __name__ == "__main__":
    import sys

    print(report(sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun",
                 mesh=None))
