"""One rank of the CPU runs of a many-card cell (test_duckbench_world.py):
joins a gloo group as the harness's ranks join theirs (``ranks.join``, from
the variables torch.distributed.run sets) and
runs each case of the cell at the tests' tiny size (``run.run_cell`` with
the rank's shard), leaving each result in ``<out>/<case>.rank<r>.json``.
Not a test module, so that ``spawn`` imports it in each rank."""

from __future__ import annotations

import json
import os


def rank_main(rank: int, world: int, port: int, out: str, cell_name: str, cases: list,
              seed: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch

    from duckbench import manifest, ranks, run
    from test_duckbench_runs import tiny

    torch.set_num_threads(1)
    run.prepare()
    bench = manifest.load()
    cell = manifest.workload(bench, cell_name)
    mix = dict(manifest.traffic(cell["traffic"]), follow=2)
    cfg = tiny(manifest.config(bench, cell["config"]))
    shard = ranks.join(device="cpu", timeout_s=600)
    try:
        for name, kw in cases:
            res = run.run_cell(bench, cell, seed, 0.2, kw.pop("trace", False), "cpu", cfg=cfg,
                               traffic_mix=mix, shard=shard, **kw)
            res.pop("breakdown", None)
            with open(os.path.join(out, f"{name}.rank{rank}.json"), "w") as f:
                json.dump(res, f)
    finally:
        ranks.leave()
