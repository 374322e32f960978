"""Subprocess body: the JAX package's model on a forced 4-host-device
``(2, 2)`` mesh (``MeshRules``, jitted), against 4 gloo ranks of the port
at the same mesh (spawned processes), in float32:

* the collectives over sub-meshes ("model", "data", and both in the
  order ("model", "data")) on known values;
* every rank's block of the dense and MoE smoke trees (fsdp off and on,
  and the ZeRO-1 layout of a train state) equals the JAX shard on the
  device at its mesh position (``mesh.devices.flat[r]``), bit for bit;
* forward logits and the loss within 2e-5 of the largest |logit| (and
  rtol 2e-5): dense and MoE, ``moe_impl`` ``shard_map`` and ``gspmd``,
  fsdp off and on, and a vocabulary of 255, which divides by nothing, so
  ``embed`` is replicated over ``model`` (the smoke configs' 256 is
  vocab-parallel);
* prefill and 4 greedy decode steps: tokens equal, logits within 2e-5
  of the largest, with the ring's slots over ``model`` (B = 4) and over
  ``(data, model)`` (B = 1, ``long_seq``), and through the
  ``decode_attention`` op with its log-sum-exp;
* three ``jit_train_step`` steps: ZeRO-1 with microbatch 2, no ZeRO-1
  with fsdp and the ``gspmd`` dispatch, ZeRO-1 with ``grad_compress``,
  ZeRO-1 with the vocabulary of 255:
  loss and grad norm within rtol 1e-4, every gathered leaf of
  ``params``, ``m`` and ``v`` within 2e-4 of the leaf's largest
  magnitude (``grad_compress``: the moments within 2**-8, as
  ``test_torch_train.py`` states);
* a checkpoint JAX saved on its 4 devices restores on 2 port ranks
  (each its block, equal to the saved arrays), and one the 4 port ranks
  saved restores in JAX onto its mesh, within the leaf tolerance of
  JAX's own state.

Invoked by ``test_torch_sharding.py``; prints 'OK' on success.  JAX is
imported in the parent process only, which writes the weights and
initial states first (``init.npz``), then its results (``jax.npz``)."""
import dataclasses
import datetime
import os
import sys
import tempfile
import time

import numpy as np

RANKS = 4
SHAPE, NAMES = (2, 2), ("data", "model")
B, S, STEPS, NEW = 4, 16, 3, 4
MAX_LEN = 32
TOL = 2e-5
SCALAR_RTOL, LEAF_TOL, COMPRESS_TOL = 1e-4, 2e-4, 2.0 ** -8

#: name -> (arch, config changes)
FORWARD = {
    "dense": ("qwen3-0.6b", {}),
    "moe": ("granite-moe-3b-a800m", {}),
    "moe_gspmd": ("granite-moe-3b-a800m", {"moe_impl": "gspmd"}),
    "moe_fsdp": ("granite-moe-3b-a800m", {"fsdp": True}),
    # a vocabulary that divides by nothing: ``embed`` replicated over
    # ``model`` (the fallback granite-moe's 49,155 takes at full width)
    "moe_vocab_fallback": ("granite-moe-3b-a800m", {"vocab_size": 255}),
}
#: name -> (arch, config changes, batch)
SERVE = {
    "dense_decode": ("qwen3-0.6b", {}, B),
    "dense_decode_kernel_op": ("qwen3-0.6b", {"attn_impl": "pallas"}, B),
    "moe_long_seq": ("granite-moe-3b-a800m", {"attn_impl": "pallas"}, 1),
}
#: name -> (arch, config changes, TrainConfig changes)
TRAIN = {
    "moe_zero1_microbatch": ("granite-moe-3b-a800m", {"microbatch": 2},
                             {"zero1": True}),
    "moe_fsdp_gspmd": ("granite-moe-3b-a800m",
                       {"fsdp": True, "moe_impl": "gspmd"}, {"zero1": False}),
    "dense_zero1_compress": ("qwen3-0.6b", {}, {"zero1": True,
                                                "grad_compress": True}),
    "moe_vocab_fallback": ("granite-moe-3b-a800m", {"vocab_size": 255},
                           {"zero1": True}),
}
#: the forward cases whose blocks are compared
BLOCKS = ("dense", "moe", "moe_fsdp", "moe_vocab_fallback")
TC = dict(total_steps=10, warmup_steps=1)
CKPT_CASE = "moe_zero1_microbatch"


def _cfg(configs, arch, kw):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32", **kw)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


def flat(tree, prefix=""):
    """{'a/b': leaf} of a nested dict (or ParamTree)."""
    out = {}
    for k in sorted(tree.keys()):
        v = tree[k]
        key = f"{prefix}{k}"
        if hasattr(v, "keys"):
            out.update(flat(v, key + "/"))
        else:
            out[key] = v
    return out


def nest(items):
    out = {}
    for key, v in items.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# the JAX side (parent process)
# ---------------------------------------------------------------------------

def jax_side(tmp):
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={RANKS}"
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.data.tokens import TokenPipeline
    from repro.launch.mesh import make_mesh
    from repro.models import lm as JL
    from repro.models.api import get_model
    from repro.sharding.rules import MeshRules
    from repro.train import step as JS
    from repro.train.checkpoints import CheckpointManager

    mesh = make_mesh(SHAPE, NAMES)
    devices = list(mesh.devices.flat)
    init, out = {}, {}

    def blocks(prefix, tree):
        """Each device's shard, by mesh position."""
        for key, a in flat(tree).items():
            for shard in a.addressable_shards:
                r = devices.index(shard.device)
                out[f"{prefix}/{key}/{r}"] = np.asarray(shard.data)

    for name, (arch, kw) in FORWARD.items():
        jc = _cfg(configs, arch, kw)
        init[f"fwd/{name}"] = get_model(jc).init(jc, jax.random.PRNGKey(7))
    for name, (arch, kw, b) in SERVE.items():
        jc = _cfg(configs, arch, kw)
        init[f"serve/{name}"] = get_model(jc).init(jc,
                                                   jax.random.PRNGKey(8))
    for name, (arch, kw, tkw) in TRAIN.items():
        init[f"train/{name}"] = JS.init_train_state(
            _cfg(configs, arch, kw), jax.random.PRNGKey(9))
    np.savez(f"{tmp}/init.tmp.npz", **{
        f"{case}/{key}": np.asarray(a) for case, t in init.items()
        for key, a in flat(t).items()})
    os.replace(f"{tmp}/init.tmp.npz", f"{tmp}/init.npz")
    with mesh:
        for name, (arch, kw) in FORWARD.items():
            jc = _cfg(configs, arch, kw)
            rules = MeshRules(mesh, fsdp=jc.fsdp)
            model = get_model(jc)
            params = init[f"fwd/{name}"]
            params = jax.device_put(params, model.shardings(jc, rules))
            if name in BLOCKS:
                blocks(f"block/{name}", params)
            batch = TokenPipeline(jc, B, S, seed=1).batch_at(0)
            logits, aux = jax.jit(lambda p, t: JL.forward(
                jc, p, t, rules=rules))(params, jnp.asarray(batch["tokens"]))
            loss, metrics = jax.jit(lambda p, b: JL.loss_fn(
                jc, p, b, rules))(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            out[f"fwd/{name}/logits"] = np.asarray(logits)
            out[f"fwd/{name}/aux"] = np.asarray(aux)
            out[f"fwd/{name}/loss"] = np.asarray(loss)
            out[f"fwd/{name}/nll"] = np.asarray(metrics["nll"])
        for name, (arch, kw, b) in SERVE.items():
            jc = _cfg(configs, arch, kw)
            rules = MeshRules(mesh, fsdp=jc.fsdp)
            model = get_model(jc)
            params = jax.device_put(init[f"serve/{name}"],
                                    model.shardings(jc, rules))
            toks = _tokens(jc.vocab_size, b, S, seed=2)
            prefill = jax.jit(lambda p, t: JL.prefill(jc, p, t, MAX_LEN,
                                                      rules=rules))
            decode = jax.jit(lambda p, c, t: JL.decode_step(jc, p, c, t,
                                                            rules))
            cache, logits = prefill(params, jnp.asarray(toks))
            out[f"serve/{name}/logits/0"] = np.asarray(logits)
            for i in range(NEW):
                nxt = jnp.argmax(logits, -1).astype(jnp.int32)
                out[f"serve/{name}/tokens/{i}"] = np.asarray(nxt)
                cache, logits = decode(params, cache, nxt)
                out[f"serve/{name}/logits/{i + 1}"] = np.asarray(logits)
        for name, (arch, kw, tkw) in TRAIN.items():
            jc = _cfg(configs, arch, kw)
            rules = MeshRules(mesh, fsdp=jc.fsdp)
            tc = JS.TrainConfig(**TC, **tkw)
            state = jax.device_put(init[f"train/{name}"],
                                   JS.state_shardings(jc, rules, tc))
            if name == CKPT_CASE:
                blocks(f"block/{name}", state["params"])
            step = JS.jit_train_step(jc, rules, tc)
            pipe = TokenPipeline(jc, B, S, seed=0)
            for i in range(STEPS):
                state, m = step(state, {k: jnp.asarray(v) for k, v in
                                        pipe.batch_at(i).items()})
                for k in ("loss", "grad_norm", "nll", "aux"):
                    out[f"train/{name}/{i}/{k}"] = np.asarray(m[k])
            for key, a in flat(state).items():
                out[f"train/{name}/final/{key}"] = np.asarray(a)
            if name == CKPT_CASE:
                CheckpointManager(f"{tmp}/jax_ckpt").save(STEPS, state)
    np.savez(f"{tmp}/jax.tmp.npz", **out)
    os.replace(f"{tmp}/jax.tmp.npz", f"{tmp}/jax.npz")


def jax_restore(tmp):
    """The port's 4-rank checkpoint restored in JAX onto its mesh, against
    JAX's own final state of the same case."""
    import jax
    from repro import configs
    from repro.launch.mesh import make_mesh
    from repro.sharding.rules import MeshRules
    from repro.train import step as JS
    from repro.train.checkpoints import CheckpointManager
    arch, kw, tkw = TRAIN[CKPT_CASE]
    jc = _cfg(configs, arch, kw)
    mesh = make_mesh(SHAPE, NAMES)
    tc = JS.TrainConfig(**TC, **tkw)
    want = np.load(f"{tmp}/jax.npz")
    with mesh:
        shard = JS.state_shardings(jc, MeshRules(mesh), tc)
        template = JS.init_train_state(jc, jax.random.PRNGKey(0))
        step, state = CheckpointManager(f"{tmp}/port_ckpt").restore(
            template=template, shardings=shard)
    assert step == STEPS, step
    got = flat(state)
    for key, a in got.items():
        assert len(a.sharding.device_set) == RANKS, key
        w = want[f"train/{CKPT_CASE}/final/{key}"]
        close(np.asarray(a), w, LEAF_TOL, f"JAX restore of the port's "
              f"checkpoint: {key}")
    print(f"the port's 4-rank checkpoint restores in JAX on {RANKS} "
          f"devices: {len(got)} leaves", flush=True)


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if want.dtype.kind in "iub":
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: differs")
        return 0.0
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    if not err <= tol:
        raise AssertionError(f"{what}: {err:.3e} of the max > {tol:.1e}")
    return err


def wait_for(path, timeout=900.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return np.load(path)


# ---------------------------------------------------------------------------
# the port (spawned ranks)
# ---------------------------------------------------------------------------

def rank_main(rank, tmp):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(seconds=600))
    try:
        _rank(rank, tmp)
    finally:
        dist.destroy_process_group()


def collectives(mesh, rank):
    """The sub-mesh collectives (A9b) on known values: rank r = (d, m)
    holds x = [[r, 10 r]]; over "model" the shards are (d, 0), (d, 1),
    over ("model", "data") model-major."""
    import torch
    from repro_torch.core.collectives import Collectives
    d, m = divmod(rank, 2)
    x = torch.tensor([[rank, 10 * rank]], dtype=torch.float32)
    out = []
    for axes, members, index in (("model", [2 * d, 2 * d + 1], m),
                                 ("data", [m, 2 + m], d),
                                 (("model", "data"), [0, 2, 1, 3],
                                  2 * m + d)):
        c = Collectives(mesh, axes)
        assert (c.size, c.index()) == (len(members), index), axes
        want = torch.tensor([[r, 10 * r] for r in members],
                            dtype=torch.float32)
        assert torch.equal(c.all_gather(x, 0), want), axes
        assert torch.equal(c.all_gather(x, 1), want.reshape(1, -1)), axes
        total = want.sum(0, keepdim=True)
        assert torch.equal(c.psum(x), total), axes
        assert torch.equal(c.pmax(x), want.max(0, keepdim=True).values)
        assert torch.equal(c.reduce_scatter(x.repeat(1, c.size), 1),
                           total), axes
        # block j of shard i goes to shard j, in shard order
        rows = torch.tensor([[100 * index + j] for j in range(c.size)])
        assert torch.equal(c.all_to_all(rows), torch.tensor(
            [[100 * k + index] for k in range(c.size)])), axes
        out.append(f"collectives over {axes}: all_gather (dims 0, 1), "
                   "all_to_all, psum, pmax, reduce_scatter, index")
    return out


def _rank(rank, tmp):
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as L
    from repro_torch.models.api import get_model
    from repro_torch.models.params import from_jax_params, tree_items
    from repro_torch.sharding import MeshRules
    from repro_torch.train import step as TS
    from repro_torch.train.checkpoints import CheckpointManager

    mesh = make_mesh(SHAPE, NAMES, device="cpu")
    # a 2-rank mesh of ranks 0 and 1 for the elastic restore (every rank
    # creates the group)
    pair = dist.new_group([0, 1])
    report = collectives(mesh, rank)
    init = wait_for(f"{tmp}/init.npz")
    got, blocks = {}, {}

    def tree(prefix):
        return nest({k[len(prefix) + 1:]: init[k] for k in init.files
                     if k.startswith(prefix + "/")})

    # compute everything, then compare with JAX's results
    for name, (arch, kw) in FORWARD.items():
        cfg = _cfg(configs, arch, kw)
        rules = MeshRules(mesh, fsdp=cfg.fsdp)
        model = get_model(cfg)
        params = from_jax_params(tree(f"fwd/{name}"), "cpu",
                                 shardings=model.shardings(cfg, rules))
        if name in BLOCKS:
            blocks[name] = params
        batch = TokenPipeline(cfg, B, S, seed=1).batch_at(0)
        with torch.no_grad():
            logits, aux = model.forward(cfg, params, batch, rules)
            loss, metrics = model.loss(cfg, params, batch, rules)
        got[f"fwd/{name}"] = (logits, aux, loss, metrics["nll"])
    for name, (arch, kw, b) in SERVE.items():
        cfg = _cfg(configs, arch, kw)
        rules = MeshRules(mesh, fsdp=cfg.fsdp)
        model = get_model(cfg)
        params = from_jax_params(tree(f"serve/{name}"), "cpu",
                                 shardings=model.shardings(cfg, rules))
        toks = _tokens(cfg.vocab_size, b, S, seed=2)
        cache, logits = L.prefill(cfg, params, toks, MAX_LEN, rules=rules)
        steps = [(None, logits)]
        for i in range(NEW):
            nxt = torch.argmax(logits, -1)
            cache, logits = L.decode_step(cfg, params, cache, nxt, rules)
            steps.append((nxt, logits))
        got[f"serve/{name}"] = steps
    states = {}
    for name, (arch, kw, tkw) in TRAIN.items():
        cfg = _cfg(configs, arch, kw)
        rules = MeshRules(mesh, fsdp=cfg.fsdp)
        tc = TS.TrainConfig(**TC, **tkw)
        shard = TS.state_shardings(cfg, rules, tc)
        state = TS.from_jax_state(tree(f"train/{name}"), "cpu",
                                  shardings=shard)
        if name == CKPT_CASE:
            blocks[name] = tree_items(state["params"])
            blocks[name] = {p: x.detach().clone() for p, x in blocks[name]}
        step = TS.make_train_step(cfg, rules, tc)
        pipe = TokenPipeline(cfg, B, S, seed=0)
        rows = []
        for i in range(STEPS):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                    pipe.batch_at(i).items()})
            rows.append({k: float(v) for k, v in m.items()})
        sh = dict(tree_items(shard))
        gathered = {path: sh[path].gather(leaf.detach())
                    for path, leaf in tree_items(state)}
        states[name] = (cfg, tc, shard, state, rows, gathered)
    cfg, tc, shard, state, _, gathered = states[CKPT_CASE]
    CheckpointManager(f"{tmp}/port_ckpt").save(STEPS, state,
                                                shardings=shard)
    if rank == 0:
        _, back = CheckpointManager(f"{tmp}/port_ckpt").restore(
            device="cpu")
        back = dict(tree_items(back))
        for path, g in gathered.items():
            if not torch.equal(back[path], g):
                raise AssertionError(f"the port's checkpoint: {path} "
                                     "differs from the gathered state")

    want = wait_for(f"{tmp}/jax.npz")
    for name, params in blocks.items():
        n = 0
        items = params.items() if isinstance(params, dict) \
            else tree_items(params)
        for path, leaf in items:
            key = f"block/{name}/{'/'.join(path)}/{rank}"
            if key not in want.files:
                continue
            w, g = want[key], leaf.detach().numpy()
            if g.shape != w.shape or not np.array_equal(g, w):
                raise AssertionError(f"rank {rank} block {key}: "
                                     f"{g.shape} vs {w.shape}")
            n += 1
        if not n:
            raise AssertionError(f"{name}: no block compared")
        report.append(f"{name}: {n} blocks of rank {rank} equal to the JAX "
                      "shards")
    for name in FORWARD:
        logits, aux, loss, nll = got[f"fwd/{name}"]
        e = close(logits.numpy(), want[f"fwd/{name}/logits"], TOL,
                  f"{name} logits")
        for k, v in (("aux", aux), ("loss", loss), ("nll", nll)):
            np.testing.assert_allclose(float(v), want[f"fwd/{name}/{k}"],
                                       rtol=TOL, atol=1e-7,
                                       err_msg=f"{name} {k}")
        report.append(f"{name}: forward logits within {e:.2e} of the max, "
                      f"loss {float(loss):.6f}")
    for name, (_, _, b) in SERVE.items():
        worst = 0.0
        for i, (nxt, logits) in enumerate(got[f"serve/{name}"]):
            if nxt is not None and not np.array_equal(
                    nxt.numpy(), want[f"serve/{name}/tokens/{i - 1}"]):
                raise AssertionError(f"{name}: greedy tokens of step {i}")
            worst = max(worst, close(logits.numpy(),
                                     want[f"serve/{name}/logits/{i}"], TOL,
                                     f"{name} logits {i}"))
        report.append(f"{name} (B {b}): prefill and {NEW} decode steps, "
                      f"tokens equal, logits within {worst:.2e}")
    for name, (cfg, tc, shard, state, rows, gathered) in states.items():
        for i, m in enumerate(rows):
            for k in ("loss", "grad_norm", "nll", "aux"):
                np.testing.assert_allclose(
                    m[k], want[f"train/{name}/{i}/{k}"], rtol=SCALAR_RTOL,
                    atol=1e-6, err_msg=f"{name} step {i} {k}")
        worst = 0.0
        for path, g in gathered.items():
            key = "/".join(path)
            tol = (COMPRESS_TOL if tc.grad_compress
                   and path[:2] in (("opt", "m"), ("opt", "v"))
                   else LEAF_TOL)
            worst = max(worst, close(g.numpy(),
                                     want[f"train/{name}/final/{key}"],
                                     tol, f"{name} {key}"))
        report.append(f"{name}: {STEPS} steps, loss and grad norm within "
                      f"rtol {SCALAR_RTOL}, {len(gathered)} gathered leaves "
                      f"within {worst:.2e} of their max")
    # the JAX checkpoint of the ZeRO-1 case on 2 ranks
    cfg, tc = states[CKPT_CASE][:2]
    if rank < 2:
        pm = make_mesh((1, 2), NAMES, device="cpu", group=pair)
        psh = TS.state_shardings(cfg, MeshRules(pm, fsdp=cfg.fsdp), tc)
        mgr = CheckpointManager(f"{tmp}/jax_ckpt")
        step_, local = mgr.restore(shardings=psh)
        saved = dict(tree_items(mgr.restore()[1]))
        local = dict(tree_items(local))
        assert step_ == STEPS
        for path, s_ in tree_items(psh):
            if not np.array_equal(local[path], s_.local(saved[path])):
                raise AssertionError(f"elastic restore of {path}")
        report.append(f"the JAX 4-device checkpoint restores on 2 ranks "
                      f"(mesh (1, 2)), each its blocks of {len(local)} "
                      "leaves")
    dist.barrier()
    if rank == 0:
        for line in report:
            print(line, flush=True)


def main():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.start_processes(rank_main, args=(tmp,), nprocs=RANKS,
                                   start_method="spawn", join=False)
        try:
            jax_side(tmp)
            while not ranks.join():
                pass
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
        jax_restore(tmp)
    print("OK")


if __name__ == "__main__":
    sys.exit(main())
