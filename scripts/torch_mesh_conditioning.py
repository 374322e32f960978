"""How far two correct float32 evaluations of granite-moe-3b-a800m lie
apart at full width and 2 layers, on the CPU: the ground of the limits
of ``chip_smoke.py`` phase 15b's fp32 gate and 15c's training gate.

    PYTHONPATH=src python scripts/torch_mesh_conditioning.py [--train]

``--train``: one rank, phase 15c's batch (2 x 512 tokens): the gradient
of ``lm.loss_fn`` (its cross entropy: no aux loss) in float32 as one
batch, in float32 as the two halves' gradients summed (the data-parallel
split of a (2, 2) mesh, without its tensor parallelism), and in float64;
per leaf the largest |error|
over the leaf's largest |gradient| (after one step ``m`` is 0.1 times
the gradient, so these are ``m``'s errors too).  About 2 minutes, ~8
GB.

Without it:
Two gloo ranks on the CPU, mesh (data 1, model 2), and one rank alone
run the same teacher-forced prefill (2 x 512 tokens) and 4 decode steps
(the mesh's greedy tokens fed to both), in float32 and with the compute
in float64 (this script swaps ``models.lm.compute_dtype``; the logits,
the router and the decode scores stay float32 in the model, so the
float64 run is the float32 computation's reference to about 1e-7).
Printed per row: the largest |difference| over the row's largest
|logit|, for the mesh against one rank in float32 and in float64, and
for each float32 run against the float64 one-rank run.  About a minute
on 8 cores, ~6 GB.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

LAYERS, B, S, NEW, MAX_LEN = 2, 2, 512, 4, 640


def run(cfg, params, rules, toks, feed, dtype):
    """(rows of logits, the greedy tokens fed) of a teacher-forced run."""
    from repro_torch.models import lm as L
    real = L.compute_dtype
    L.compute_dtype = lambda c: dtype
    try:
        cache, lg = L.prefill(cfg, params, toks, MAX_LEN, rules=rules)
        rows, fed = [lg], []
        for i in range(NEW):
            nxt = torch.argmax(lg, -1) if feed is None else feed[i]
            fed.append(nxt)
            cache, lg = L.decode_step(cfg, params, cache, nxt, rules)
            rows.append(lg)
    finally:
        L.compute_dtype = real
    return [r.double() for r in rows], fed


def rank_main(rank: int, tmp: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import get_model
    from repro_torch.sharding import MeshRules
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=600))
    try:
        cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                  dtype="float32", n_layers=LAYERS)
        rules = MeshRules(make_mesh((1, 2), ("data", "model"),
                                    device="cpu"))
        model = get_model(cfg)
        toks = TokenPipeline(cfg, B, S, seed=1).batch_at(0)["tokens"]
        out = {}
        fed = None
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            mesh_p = model.init(cfg, torch.Generator().manual_seed(1),
                                dtype=dtype, device="cpu", rules=rules)
            out[f"mesh {name}"], got = run(cfg, mesh_p, rules, toks, fed,
                                           dtype)
            fed = fed or got
            del mesh_p
            if rank == 0:
                one = model.init(cfg, torch.Generator().manual_seed(1),
                                 dtype=dtype, device="cpu")
                out[f"one {name}"], _ = run(cfg, one, None, toks, fed, dtype)
                del one
        if rank == 0:
            def rel(a, b):
                return ["%.3e" % float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(out[a], out[b])]
            print(f"{cfg.name}, {LAYERS} layers at full width, {B} x {S} "
                  f"tokens, prefill + {NEW} decode steps; max |d logit| / "
                  "max |logit| per row:")
            for a, b in (("mesh f32", "one f32"), ("mesh f64", "one f64"),
                         ("one f32", "one f64"), ("mesh f32", "one f64")):
                print(f"  {a} against {b}: {rel(a, b)}")
    finally:
        dist.destroy_process_group()


def train_part() -> None:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm as L
    from repro_torch.models.api import get_model
    from repro_torch.models.params import ParamTree, tree_items, tree_map
    # no aux loss: its product of two batch means is not a sum over the
    # halves, and the mesh sums both means before the product anyway
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              dtype="float32", n_layers=LAYERS,
                              router_aux_weight=0.0)
    p32 = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                              device="cpu", requires_grad=True)
    batch = TokenPipeline(cfg, 2, 512, seed=0).batch_at(0)

    def grads(p, b, dtype):
        real = L.compute_dtype
        L.compute_dtype = lambda c: dtype
        try:
            loss, _ = L.loss_fn(cfg, p, b)
            items = tree_items(p)
            g = torch.autograd.grad(loss, [x for _, x in items])
        finally:
            L.compute_dtype = real
        return {path: x.double() for (path, _), x in zip(items, g)}

    whole = grads(p32, batch, torch.float32)
    # the loss is a mean over the batch's valid labels: the halves' own
    # means, each weighted by its share of the labels, sum to it
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    valid = [float((h["labels"] >= 0).sum()) for h in halves]
    split = None
    for h, n in zip(halves, valid):
        g = grads(p32, h, torch.float32)
        w = n / sum(valid)
        split = ({k: v * w for k, v in g.items()} if split is None
                 else {k: split[k] + v * w for k, v in g.items()})
    p64 = ParamTree.from_tensors(tree_map(lambda t: t.detach().double(),
                                          p32), requires_grad=True)
    exact = grads(p64, batch, torch.float64)
    print(f"{cfg.name}, {LAYERS} layers at full width, 2 x 512 tokens: "
          "max |gradient error| / max |gradient| by leaf "
          "(float32 whole / float32 as two halves / the two float32 runs "
          "against each other):")
    worst = [0.0, 0.0, 0.0]
    for path, e in exact.items():
        scale = float(e.abs().max())
        errs = [float((whole[path] - e).abs().max()) / scale,
                float((split[path] - e).abs().max()) / scale,
                float((split[path] - whole[path]).abs().max()) / scale]
        worst = [max(a, b) for a, b in zip(worst, errs)]
        print(f"  {'/'.join(path)}: " + " / ".join("%.3e" % x for x in errs))
    print("worst leaf: " + " / ".join("%.3e" % x for x in worst))


def main() -> int:
    if "--train" in sys.argv[1:]:
        train_part()
        return 0
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(tmp,), nprocs=2,
                           start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
