#!/usr/bin/env python3
"""Where the GNN family's and DIN's time goes on the card: one train step of
MACE at full width on a minibatch_lg batch (the sampler over a Reddit-sized
random CSR graph, edges cut 10× as in chip_smoke.py's path r3), one of
EquiformerV2 at full width on the molecule shape, and DIN's serve_bulk
forward (B = 262,144), each warmed, then under ``torch.profiler``: the wall,
the device's busy share, the launches and the ops by device time.

    python3 scripts/gnn_din_probe.py            # from the repository root, on a card
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def profiled(label: str, fn, reps: int = 2) -> None:
    """``fn`` warmed once, then ``reps`` calls under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    print(f"{label}: wall {wall:.2f} ms a call under the profiler, device busy {dev_ms:.2f} ms"
          f" ({dev_ms / wall:.3f}), {launches:.0f} kernel launches a call", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=12), flush=True)


def main() -> int:
    import torch

    from repro_torch.configs.din_arch import DIN, DIN_SHAPES
    from repro_torch.configs.gnn_family import EQUIFORMER_V2, MACE
    from repro_torch.data.graphs import CSRGraph, NeighborSampler, make_molecule_batch
    from repro_torch.data.recsys import make_din_batch
    from repro_torch.models.din import din_forward, din_init
    from repro_torch.models.gnn.models import gnn_init, gnn_loss
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import make_train_step

    if not torch.cuda.is_available():
        print("gnn_din_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)

    g = CSRGraph.random(232_965, 11_461_589, 602, 41, seed=0)
    batch = NeighborSampler(g, [15, 10], 1024, seed=0, device=dev).sample().as_inputs()
    del g
    cfg = MACE.cfg_for("minibatch_lg")
    params = gnn_init(cfg, torch.Generator(dev).manual_seed(20))
    step = make_train_step(lambda p, b: gnn_loss(p, b, cfg), MACE.opt)
    state = [params, adamw_init(params, MACE.opt)]

    def mace_step():
        state[0], state[1], _ = step(state[0], state[1], batch)

    profiled(f"MACE minibatch_lg train step ({batch['pos'].shape[0]} nodes,"
             f" {batch['edge_src'].shape[0]} edges)", mace_step)
    del state, params, batch
    torch.cuda.empty_cache()

    mol = make_molecule_batch(128, 30, 64, device=dev).as_inputs()
    cfg = EQUIFORMER_V2.cfg_for("molecule")
    params = gnn_init(cfg, torch.Generator(dev).manual_seed(12))
    step = make_train_step(lambda p, b: gnn_loss(p, b, cfg, 128), EQUIFORMER_V2.opt)
    state = [params, adamw_init(params, EQUIFORMER_V2.opt)]

    def eqv2_step():
        state[0], state[1], _ = step(state[0], state[1], mol)

    profiled("EquiformerV2 molecule train step (12 layers)", eqv2_step)
    del state, params
    torch.cuda.empty_cache()

    dcfg = DIN.full
    params = din_init(dcfg, torch.Generator(dev).manual_seed(0))
    b = make_din_batch(DIN_SHAPES["serve_bulk"]["batch"], seq_len=dcfg.seq_len,
                       n_items=dcfg.n_items, n_users=dcfg.n_users, seed=1, device=dev)
    with torch.no_grad():
        profiled("DIN serve_bulk forward (B = 262,144)", lambda: din_forward(params, b, dcfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
