"""Multi-rank runs for the port's tests, and the reference's multi-device
numbers they are held to.

``run_ranks(scenario, n, args)`` starts ``n`` processes of this file, each
a rank of a gloo process group that meets through a ``file://`` store, and
returns what each rank's :data:`SCENARIOS` function returned (JSON, or
numpy arrays under ``"arrays"``).  Every rank has a time limit; a rank that
fails fails the call with its output.

``run_reference(scenario, n_devices, args)`` runs one of
:data:`REFERENCE` in a process of its own in which JAX sees ``n_devices``
placeholder CPU devices (``XLA_FLAGS`` set before JAX starts), on meshes
with ``Auto`` axes: the reference's own ``make_mesh`` makes ``Explicit``
axes under the installed JAX, on which its sharding constraints raise.

    python tests/_torch_dist.py port <scenario> <rank> <world> <store> <dir>
    python tests/_torch_dist.py ref <scenario> <n_devices> <dir>

Arguments go in ``<dir>/args.json``; results come back in
``<dir>/out<rank>.json`` and ``<dir>/out<rank>.npz``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
RANK_TIMEOUT_S = 240
GRANITE = dict(arch="granite-3-2b", seq=32, batch=8, seed=5, lr=2e-3)
OLMOE = dict(arch="olmoe-1b-7b", seq=16, batch=8, seed=5, lr=2e-3)


def _env(extra: dict | None = None) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + str(HERE), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    env.update(extra or {})
    return env


def _results(d: pathlib.Path, n: int) -> list[dict]:
    out = []
    for r in range(n):
        res = json.loads((d / f"out{r}.json").read_text())
        npz = d / f"out{r}.npz"
        if npz.exists():
            with np.load(npz) as f:
                res["arrays"] = {k: f[k] for k in f.files}
        out.append(res)
    return out


def run_ranks(scenario: str, n: int, args: dict | None = None,
              timeout: float = RANK_TIMEOUT_S, base=None) -> list[dict]:
    """``n`` gloo ranks of ``scenario`` (files under ``base``); -> each
    rank's result."""
    d = pathlib.Path(tempfile.mkdtemp(prefix=f"ranks_{scenario}_",
                                      dir=base))
    (d / "args.json").write_text(json.dumps(args or {}))
    store = d / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist.py"), "port", scenario,
         str(r), str(n), str(store), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(ROOT)) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"{scenario}: ranks failed {bad}:\n" + "\n".join(
        l[-3000:] for l in logs)
    return _results(d, n)


def run_reference(scenario: str, n_devices: int, args: dict | None = None,
                  timeout: float = RANK_TIMEOUT_S, base=None) -> dict:
    """The reference's ``scenario`` on ``n_devices`` placeholder CPU
    devices (files under ``base``); -> its result."""
    d = pathlib.Path(tempfile.mkdtemp(prefix=f"ref_{scenario}_", dir=base))
    (d / "args.json").write_text(json.dumps(args or {}))
    p = subprocess.run(
        [sys.executable, str(HERE / "_torch_dist.py"), "ref", scenario,
         str(n_devices), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count="
                               f"{n_devices}"}),
        cwd=str(ROOT), timeout=timeout)
    assert p.returncode == 0, f"reference {scenario}:\n{p.stdout[-4000:]}"
    res = _results(d, 1)[0]
    res["dir"] = str(d)
    return res


# ------------------------------------------------------------ port ranks

def _flat(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _data(cfg, spec: dict):
    from repro_torch.train import data as data_lib
    return data_lib.SyntheticLM(data_lib.LMTaskConfig(
        vocab_size=cfg.vocab_size, seq_len=spec["seq"],
        global_batch=spec["batch"], seed=spec["seed"]))


def port_collectives(group, rank, world, args):
    """ring_shift, gather_islands and the compressed mean on rank-drawn
    values; the inputs of the compressed mean come from ``args``."""
    import torch
    from repro_torch.distributed import collectives as C
    rows = {"cores": torch.arange(6, dtype=torch.int32).reshape(3, 2)
            + 100 * rank,
            "times": torch.full((3,), float(rank), dtype=torch.float64)}
    shifted = C.ring_shift(rows, size=world, group=group)
    back = C.ring_shift(shifted, size=world, group=group, shift=-1)
    stacked = C.gather_islands(rows, group=group)
    tiled = C.gather_islands(rows, group=group, tiled=True)
    arrays = {"shifted_cores": _np(shifted["cores"]),
              "shifted_times": _np(shifted["times"]),
              "stacked_cores": _np(stacked["cores"]),
              "tiled_cores": _np(tiled["cores"]),
              "back_equal": np.array(all(torch.equal(back[k], rows[k])
                                         for k in rows))}
    if args.get("compressed"):
        with np.load(args["compressed"]) as f:
            g = {k: torch.from_numpy(f[k][rank]) for k in ("a", "b")}
        err = C.init_error_feedback(g)
        for i in range(2):
            gi = {k: v * (1 + i) for k, v in g.items()}
            mean, err = C.compressed_grad_mean(gi, err, group)
            for k in mean:
                arrays[f"mean{i}_{k}"] = _np(mean[k])
                arrays[f"err{i}_{k}"] = _np(err[k])
    return {}, arrays


def port_mesh(group, rank, world, args):
    """``make_mesh`` over the world: the (world, 1) mesh's sizes, groups
    and coordinates, and the shapes it refuses."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((world, 1), ("data", "model"))
    ctx = make_ctx(m)
    refused = {}
    for shape in ((1, 1), (world, 2), (2 * world, 1)):
        try:
            make_mesh(shape, ("data", "model"))
            refused[str(shape)] = None
        except ValueError as e:
            refused[str(shape)] = str(e)
    return {"axes": list(m), "sizes": m.sizes, "coords": m.coords,
            "data_group_size": C.group_size(m.groups["data"]),
            "model_group_size": C.group_size(m.groups["model"]),
            "ctx_dp_size": ctx.dp_size,
            "ctx_dp_group_size": C.group_size(ctx.dp_group),
            "refused": refused}, {}


def port_trainer(group, rank, world, args):
    """A data-parallel ``Trainer`` over the world, resumed from
    ``args["ckpt"]`` (or from its own initial parameters), on a
    ``(world, 1)`` mesh; -> its history and recoveries."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optim, schedules
    from repro_torch.train.loop import Trainer, TrainerConfig
    spec = args["spec"]
    cfg = registry.get(spec["arch"]).smoke()
    tcfg = TrainerConfig(steps=args["steps"], log_every=1,
                         ckpt_every=args.get("ckpt_every", 100),
                         ckpt_dir=args.get("ckpt"), resume=True,
                         compress_grads=args.get("compress", False))
    t = Trainer(cfg, make_mesh((world, 1), ("data", "model")),
                optim.adamw(schedules.constant(spec["lr"])),
                _data(cfg, spec), tcfg, device="cpu")
    fault = args.get("fault_at")
    if fault is not None:
        def hook(step):
            if step == fault:
                raise RuntimeError("scripted fault")
        t.fault_hook = hook
    hist = t.run()
    return {"history": hist, "recoveries": t.recoveries,
            "start": t.start_step}, {}


def port_olmoe_loss(group, rank, world, args):
    """olmoe's smoke ``loss_fn`` on this rank's rows of the reference's
    batch and weights, experts sharded over the world (``args["ep"]``) or
    held whole without a group."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm, moe
    cfg = registry.get("olmoe-1b-7b").smoke()
    with np.load(args["params"]) as f:
        tree = _nest({k: f[k] for k in f.files})
    with np.load(args["batch"]) as f:
        batch = {k: f[k] for k in f.files}
    model = lm.params_from_numpy(cfg, tree, "cpu")
    g = group if args.get("ep", True) else None
    if g is not None:
        moe.shard_experts(model, g)
    b = batch["tokens"].shape[0] // (world if g is not None else 1)
    r = rank if g is not None else 0
    local = {k: torch.from_numpy(v[r * b:(r + 1) * b]).long()
             for k, v in batch.items()}
    with torch.no_grad():
        total, metrics = lm.loss_fn(model, local, group=g)
    return {"metrics": {k: float(v) for k, v in metrics.items()}}, {}


def _search_workload():
    from repro_torch.core.partitioner import SimEvaluator
    from repro_torch.neuromorphic import (loihi2_like, make_inputs,
                                          programmed_fc_network)
    sizes = (96, 128, 64)
    net = programmed_fc_network(list(sizes), weight_densities=[0.6] * 2,
                                act_densities=[0.3] * 2, seed=0,
                                weight_format="sparse", device="cpu")
    xs = make_inputs(sizes[0], 0.3, 2, seed=1, device="cpu")
    chip = loihi2_like()
    return net, chip, SimEvaluator(net, xs, chip)


ISLANDS = dict(engine="sharded", n_islands=4, migrate_every=2,
               population_size=16, generations=5, seed=7)


def port_islands(group, rank, world, args):
    """The island search over the world's ranks (or one process when the
    world is 1 and ``args["group"]`` is false), snapshotting every
    generation into ``args["dir"]``; ``kill_after`` crashes it after that
    generation's snapshot, ``resume`` continues from the newest one."""
    from repro_torch.core import resilience as R
    from repro_torch.core.search import evolutionary_search
    net, chip, ev = _search_workload()
    kw = dict(ISLANDS, checkpoint_dir=args["dir"], checkpoint_keep=100,
              resume=args.get("resume", False))
    if args.get("kill_after") is not None:
        kw["fault_plan"] = R.FaultPlan(kill_after_gen=args["kill_after"])
    if args.get("group", True):
        kw["group"] = group
    try:
        res = evolutionary_search(net, chip, ev, **kw)
    except R.SimulatedCrash:
        return {"crashed": True}, {}
    hist = [[h.generation, h.best_time, h.best_energy, h.mean_time,
             h.n_evals, h.front_size, h.n_quarantined] for h in res.history]
    return {"crashed": False, "history": hist,
            "candidate": [list(res.candidate.cores),
                          list(res.candidate.perm)],
            "front": [[list(c.cores), list(c.perm)] for c in res.front],
            "n_evals": res.n_evals}, {}


SCENARIOS = {"collectives": port_collectives, "mesh": port_mesh,
             "trainer": port_trainer,
             "olmoe_loss": port_olmoe_loss, "islands": port_islands}


def _port_main(scenario, rank, world, store, d) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    args = json.loads((d / "args.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        res, arrays = SCENARIOS[scenario](group, rank, world, args)
        (d / f"out{rank}.json").write_text(json.dumps(res))
        if arrays:
            np.savez(d / f"out{rank}.npz", **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- reference runs

def _ref_mesh(n: int):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((n, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=np.array(jax.devices()[:n]))


def ref_compressed(R, n, d, args):
    """The reference's ``compressed_grad_mean`` under ``shard_map`` over
    ``n`` devices, two rounds, on per-device gradients drawn here."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    rng = np.random.default_rng(9)
    g = {"a": rng.standard_normal((n, 40, 24)).astype(np.float32),
         "b": (rng.standard_normal((n, 70)) * 1e-4).astype(np.float32)}
    g["a"] *= (1.0 + np.arange(n, dtype=np.float32))[:, None, None]
    np.savez(d / "inputs.npz", **g)
    mesh = jax.make_mesh((n,), ("data",), axis_types=(AxisType.Auto,),
                         devices=np.array(jax.devices()[:n]))

    def body(gr, er):
        sq = jax.tree.map(lambda x: x[0], gr)
        se = jax.tree.map(lambda x: x[0], er)
        m, e = R.collectives.compressed_grad_mean(sq, se, ("data",))
        return (jax.tree.map(lambda x: x[None], m),
                jax.tree.map(lambda x: x[None], e))
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    err = jax.tree.map(np.zeros_like, g)
    arrays = {}
    for i in range(2):
        gi = jax.tree.map(lambda x: jnp.asarray(x * (1 + i)), g)
        mean, err = jax.tree.map(np.asarray, fn(gi, err))
        for k in mean:
            arrays[f"mean{i}_{k}"] = mean[k]
            arrays[f"err{i}_{k}"] = err[k]
    return {"inputs": str(d / "inputs.npz")}, arrays


def ref_trainers(R, n, d, args):
    """The reference's ``Trainer`` on an ``(n, 1)`` mesh: a step-0
    checkpoint, then ``steps`` steps resumed from a copy of it, exact and
    (``compress``) compressed."""
    import shutil
    spec = args["spec"]
    cfg = R.registry.get(spec["arch"]).smoke()
    mesh = _ref_mesh(n)
    out = {}
    for compress in args["modes"]:
        c0, run = d / f"step0_{int(compress)}", d / f"run_{int(compress)}"

        def trainer(steps, ckpt):
            tcfg = R.loop.TrainerConfig(steps=steps, log_every=1,
                                        ckpt_dir=str(ckpt), resume=True,
                                        compress_grads=compress)
            data = R.train_data.SyntheticLM(R.train_data.LMTaskConfig(
                vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                global_batch=spec["batch"], seed=spec["seed"]))
            return R.loop.Trainer(
                cfg, mesh, R.optim.adamw(R.schedules.constant(spec["lr"])),
                data, tcfg)
        trainer(0, c0).run()
        shutil.copytree(c0, run)
        hist = trainer(args["steps"], run).run()
        out[str(int(compress))] = {"losses": [h["loss"] for h in hist],
                                   "step0": str(c0)}
    return out, {}


def ref_olmoe_loss(R, n, d, args):
    """olmoe's smoke ``loss_fn`` on one device and on an ``(n, 1)`` mesh,
    weights from ``PRNGKey(0)``, on a (4, 16) batch drawn here."""
    import jax
    import jax.numpy as jnp
    from _repro_reference import auto_mesh
    cfg = R.registry.get("olmoe-1b-7b").smoke()
    params = R.lm.init_params(cfg, jax.random.PRNGKey(0))
    np.savez(d / "params.npz", **_flat(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(args.get("seed", 3))
    B, S = args.get("batch", 4), args.get("seq", 16)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    np.savez(d / "batch.npz", **batch)
    out = {"params": str(d / "params.npz"), "batch": str(d / "batch.npz")}
    for name, mesh in (("one", auto_mesh()), ("mesh", _ref_mesh(n))):
        ctx = R.sharding.make_ctx(mesh)
        _, m = jax.jit(lambda p, b: R.lm.loss_fn(p, b, cfg, ctx))(
            params, jax.tree.map(jnp.asarray, batch))
        out[name] = {k: float(v) for k, v in m.items()}
    return out, {}


REFERENCE = {"compressed": ref_compressed, "trainers": ref_trainers,
             "olmoe_loss": ref_olmoe_loss}


def _ref_main(scenario, n, d) -> None:
    import jax
    args = json.loads((d / "args.json").read_text())
    assert len(jax.devices()) >= n, jax.devices()
    from _repro_reference import reference
    with reference() as R:
        res, arrays = REFERENCE[scenario](R, n, d, args)
    (d / "out0.json").write_text(json.dumps(res))
    if arrays:
        np.savez(d / "out0.npz", **arrays)


if __name__ == "__main__":
    mode, scenario = sys.argv[1], sys.argv[2]
    if mode == "port":
        _port_main(scenario, int(sys.argv[3]), int(sys.argv[4]),
                   sys.argv[5], pathlib.Path(sys.argv[6]))
    else:
        _ref_main(scenario, int(sys.argv[3]), pathlib.Path(sys.argv[4]))
