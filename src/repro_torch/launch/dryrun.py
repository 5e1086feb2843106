"""Multi-pod dry run: every (arch × shape × mesh) cell on a production mesh
of 256 or 512 ranks, with no card and nothing allocated.

One process is rank 0 of a fake process group of the mesh's size
(``launch.mesh.make_dry_run_mesh``); a cell's params and batches are meta
DTensors laid out by the ``dist.sharding`` rules, and ``cell.fn`` runs on
them eagerly under ``use_mesh`` (the model's ``shard_hint``s redistribute),
``implicit_replication`` (a plain tensor the model makes, a position or a
mask, is every rank's) and two tallies (``roofline.analysis``): one rank's
flops and bytes over the aten ops the run issues, and the bytes of the
collectives DTensor issues. Each cell's record goes to
``artifacts/dryrun/<cell>.json`` with the reference's keys
(``repro.launch.dryrun``):

* ``lower_s`` is the traced run's wall; ``compile_s`` is 0.0: nothing is
  compiled (eager PyTorch runs the program as it traces it);
* ``flops`` and ``bytes_accessed`` are one rank's (the conventions are
  ``make_op_tally``'s), ``collectives`` one rank's bytes by kind, and
  ``trips`` is 1: every layer and microbatch ran (``roofline.loop_trips``);
* ``memory`` holds ``argument_size_in_bytes`` and ``output_size_in_bytes``,
  the bytes of one rank's shards of the arguments and the outputs.

A GQ-Fast cell's hop kernels cannot run on meta tensors: its ``fn`` counts
each hop's work on the local shard (``roofline.analysis.hop_work``) and its
all_reduce. A cell that fails is written with ``status="error"`` and its
traceback; the run ends with the summary line and exit code 1 when any did.

Usage (no card needed: it runs the same on any machine):
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --both-meshes [--skip-existing]
  python -m repro_torch.launch.dryrun --cells local_1x1:din:serve_bulk pod_16x16:mace:molecule
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

MESH_NAMES = {False: "pod_16x16", True: "multipod_2x16x16"}


def cell_name(arch_id: str, shape_id: str, mesh_name: str, variant: str = "") -> str:
    return f"{arch_id}__{shape_id}__{mesh_name}" + (f"__{variant}" if variant else "")


def _local_bytes(tree) -> int:
    import torch
    from torch.distributed.tensor import DTensor

    from ..tree import tree_leaves

    n = 0
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x._local_tensor
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def trace_cell(cell, mesh) -> dict:
    """Run ``cell.fn(*cell.args)`` once over ``mesh`` under the tallies;
    the record's measured keys."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.common import use_mesh
    from ..roofline.analysis import collectives_from_comm, make_comm_tally, make_op_tally

    t0 = time.time()
    with use_mesh(mesh), implicit_replication(), make_comm_tally() as comm, \
            make_op_tally() as ops:
        out = cell.fn(*cell.args)
    return {
        "lower_s": round(time.time() - t0, 2),
        "compile_s": 0.0,
        "memory": {"argument_size_in_bytes": _local_bytes(cell.args),
                   "output_size_in_bytes": _local_bytes(out)},
        "flops": float(ops.flops),
        "bytes_accessed": float(ops.bytes),
        "collectives": collectives_from_comm(comm),
        "trips": 1,
    }


def run_cell(arch_id: str, shape_id: str, mesh, mesh_name: str, out_dir: str,
             skip_existing: bool = False, variant: str = "") -> dict:
    """One cell's record on ``mesh`` (named ``mesh_name``), written to
    ``out_dir``."""
    from ..configs.registry import get_arch

    name = cell_name(arch_id, shape_id, mesh_name, variant)
    path = os.path.join(out_dir, f"{name}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    arch = get_arch(arch_id)
    rec: dict = {"arch": arch_id, "shape": shape_id, "mesh": mesh_name, "variant": variant,
                 "time": time.time()}
    skip = arch.skip_reason(shape_id)
    if skip:
        rec.update(status="skipped", reason=skip)
        _write(path, rec)
        return rec
    try:
        cell = arch.make_cell(shape_id, mesh, variant)
        measured = trace_cell(cell, mesh)
        rec.update(status="ok", kind=cell.kind, model_flops=cell.model_flops,
                   notes=cell.notes, **measured)
        print(f"[dryrun] {name}: OK  traced {rec['lower_s']:.1f}s "
              f"flops/dev {rec['flops']:.3e} bytes/dev {rec['bytes_accessed']:.3e} "
              f"coll {sum(rec['collectives'].values()):.3e}B", flush=True)
        print(f"  memory: {rec['memory']}", flush=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a fault to record
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   tb=traceback.format_exc()[-4000:])
        print(f"[dryrun] {name}: ERROR {type(e).__name__}: {str(e)[:300]}", flush=True)
    _write(path, rec)
    return rec


def run_cells(jobs: list[tuple[str, str, str]], out_dir: str, skip_existing: bool = False,
              variant: str = "") -> list[dict]:
    """``(mesh name, arch, shape)`` jobs, one mesh at a time (a process
    holds one default group: each mesh's fake group is made, used and
    destroyed in turn)."""
    from .mesh import end_dry_run_mesh, make_dry_run_mesh

    results = []
    for mesh_name in dict.fromkeys(m for m, _, _ in jobs):
        mesh = make_dry_run_mesh(mesh_name)
        try:
            for m, aid, sid in jobs:
                if m == mesh_name:
                    results.append(run_cell(aid, sid, mesh, mesh_name, out_dir,
                                            skip_existing, variant))
        finally:
            end_dry_run_mesh()
    return results


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--cells", nargs="+", metavar="MESH:ARCH:SHAPE",
                    help="run these cells only, each on its own mesh (pod_16x16,"
                         " multipod_2x16x16 or local_1x1)")
    args = ap.parse_args(argv)

    from ..configs.registry import ARCHS, all_cells

    if args.cells:
        jobs = [tuple(c.split(":")) for c in args.cells]
    else:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        if args.all:
            cells = all_cells()
        else:
            assert args.arch, "--arch required unless --all or --cells"
            shapes = [args.shape] if args.shape else ARCHS[args.arch].shape_ids
            cells = [(args.arch, s) for s in shapes]
        jobs = [(MESH_NAMES[mp], aid, sid) for mp in meshes for aid, sid in cells]

    t0 = time.time()
    results = run_cells(jobs, args.out, args.skip_existing, args.variant)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    err = [r for r in results if r["status"] == "error"]
    print(f"\n[dryrun] {ok} ok, {sk} skipped, {len(err)} errors / {len(results)} cells"
          f" in {time.time() - t0:.1f} s")
    for r in err:
        print(f"  ERROR {r['arch']}__{r['shape']}__{r['mesh']}: {r['error']}")
    raise SystemExit(1 if err else 0)


if __name__ == "__main__":
    main()
