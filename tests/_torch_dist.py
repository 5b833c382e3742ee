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


class Started:
    """Processes started by :func:`start_ranks` / :func:`start_reference`;
    ``wait()`` -> their results (a process that fails fails the call with
    its output)."""

    def __init__(self, what: str, procs, d: pathlib.Path, timeout: float,
                 reference: bool = False):
        self.what, self.procs, self.d = what, procs, d
        self.timeout, self.reference = timeout, reference

    def wait(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs)
               if p.returncode]
        assert not bad, f"{self.what}: failed {bad}:\n" + "\n".join(
            l[-4000:] for l in logs)
        if not self.reference:
            return _results(self.d, len(self.procs))
        res = _results(self.d, 1)[0]
        res["dir"] = str(self.d)
        return res


def start_ranks(scenario: str, n: int, args: dict | None = None,
                timeout: float = RANK_TIMEOUT_S, base=None) -> Started:
    """Start ``n`` gloo ranks of ``scenario`` (files under ``base``)."""
    d = pathlib.Path(tempfile.mkdtemp(prefix=f"ranks_{scenario}_",
                                      dir=base))
    (d / "args.json").write_text(json.dumps(args or {}))
    store = d / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist.py"), "port", scenario,
         str(r), str(n), str(store), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(ROOT)) for r in range(n)]
    return Started(scenario, procs, d, timeout)


def run_ranks(scenario: str, n: int, args: dict | None = None,
              timeout: float = RANK_TIMEOUT_S, base=None) -> list[dict]:
    """``n`` gloo ranks of ``scenario`` (files under ``base``); -> each
    rank's result."""
    return start_ranks(scenario, n, args, timeout, base).wait()


def start_reference(scenario: str, n_devices: int, args: dict | None = None,
                    timeout: float = RANK_TIMEOUT_S, base=None) -> Started:
    """Start the reference's ``scenario`` on ``n_devices`` placeholder CPU
    devices (files under ``base``)."""
    d = pathlib.Path(tempfile.mkdtemp(prefix=f"ref_{scenario}_", dir=base))
    (d / "args.json").write_text(json.dumps(args or {}))
    p = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist.py"), "ref", scenario,
         str(n_devices), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count="
                               f"{n_devices}"}),
        cwd=str(ROOT))
    return Started(f"reference {scenario}", [p], d, timeout, reference=True)


def run_reference(scenario: str, n_devices: int, args: dict | None = None,
                  timeout: float = RANK_TIMEOUT_S, base=None) -> dict:
    """The reference's ``scenario`` on ``n_devices`` placeholder CPU
    devices (files under ``base``); -> its result."""
    return start_reference(scenario, n_devices, args, timeout, base).wait()


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
    tp = {}
    for shape in ((2, 2), (1, 4)) if world == 4 else ():
        mm = make_mesh(shape, ("data", "model"))
        c = make_ctx(mm)
        tp[str(shape)] = {
            "sizes": mm.sizes, "coords": mm.coords,
            "data_group_size": C.group_size(mm.groups["data"]),
            "model_group_size": C.group_size(mm.groups["model"]),
            "ctx_dp_group_size": C.group_size(c.dp_group),
            "ctx_tp_group_size": C.group_size(c.tp_group),
            "ctx_tp_rank": c.tp_rank}
    return {"axes": list(m), "sizes": m.sizes, "coords": m.coords,
            "data_group_size": C.group_size(m.groups["data"]),
            "model_group_size": C.group_size(m.groups["model"]),
            "ctx_dp_size": ctx.dp_size,
            "ctx_dp_group_size": C.group_size(ctx.dp_group),
            "refused": refused, "tp": tp}, {}


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


# ------------------------------------------------- tensor parallelism
#
# The test process writes each arch's weights and inputs once
# (:func:`write_inputs`); the port's ranks and the reference's process
# read the same files.

TP_B, TP_S = 4, 16                      # the batch of every TP case
LAYER_CASES = {                         # kind -> (arch, n) pairs
    "attn_a": [("granite-3-2b", 2), ("olmoe-1b-7b", 4)],
    "attn_b": [("recurrentgemma-2b", 2), ("granite-3-2b", 4)],
    "attn_c": [("phi3-medium-14b", 2), ("phi3-medium-14b", 4)],
    "attn_c_ragged": [("phi3-medium-14b", 2), ("phi3-medium-14b", 4)],
    "mlp": [("granite-3-2b", 2), ("granite-3-2b", 4)],
    "ssd": [("mamba2-1.3b", 2), ("mamba2-1.3b", 4)],
    "rglru": [("recurrentgemma-2b", 2), ("recurrentgemma-2b", 4)],
    "moe": [("olmoe-1b-7b", 2), ("olmoe-1b-7b", 4)],
    "moe_shared": [("kimi-k2-1t-a32b", 2), ("kimi-k2-1t-a32b", 4)],
}
# branch (c) on a sequence the group does not divide: its replicated
# fallback (queries, keys and values gathered over head_dim)
LAYER_S = {"attn_c_ragged": 11}


def write_inputs(archs, d, *, seed: int = 0, batch_seed: int = 3,
                 B: int = TP_B, S: int = TP_S) -> str:
    """Each arch's smoke weights (the port's ``init_params(cfg, seed)``,
    in the reference's tree) and a (B, S) batch from
    ``default_rng(batch_seed)`` (frames or patches first where the arch
    has them) as ``params_<arch>.npz`` / ``batch_<arch>.npz`` under
    ``d``; -> ``d``."""
    from repro_torch.configs import registry
    from repro_torch.models import encdec as E
    from repro_torch.models import lm
    d = pathlib.Path(d)
    d.mkdir(parents=True, exist_ok=True)
    for arch in archs:
        cfg = registry.get(arch).smoke()
        encdec = registry.get(arch).is_encdec
        lib = E if encdec else lm
        np.savez(d / f"params_{arch}.npz", **_flat(lib.params_to_numpy(
            lib.init_params(cfg, seed, "cpu"))))
        rng = np.random.default_rng(batch_seed)
        F = 0 if encdec or cfg.frontend == "none" else cfg.frontend_tokens
        batch = {}
        if encdec:
            batch["frontend_embeds"] = rng.standard_normal(
                (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        elif F:
            batch["frontend_embeds"] = rng.standard_normal(
                (B, F, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab_size,
                                       (B, S - F)).astype(np.int32)
        batch["labels"] = rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)
        np.savez(d / f"batch_{arch}.npz", **batch)
    return str(d)


def _load(d, name: str) -> dict:
    with np.load(pathlib.Path(d) / name) as f:
        return {k: f[k] for k in f.files}


def _port_model(d, arch: str):
    """(cfg, model library, the port's model on the CPU, numpy tree)."""
    from repro_torch.configs import registry
    from repro_torch.models import encdec, lm
    entry = registry.get(arch)
    lib = encdec if entry.is_encdec else lm
    tree = _nest(_load(d, f"params_{arch}.npz"))
    return entry.smoke(), lib, lib.params_from_numpy(entry.smoke(), tree,
                                                     "cpu"), tree


def _whole_grads(model, grads):
    from repro_torch.distributed import sharding
    from repro_torch.train import step as S
    from repro_torch.tree import tree_map
    return tree_map(lambda g, sp: _np(sharding.gather_leaf(g, sp)), grads,
                    S.leaf_splits(model))


def _optimizer(mod, t: dict):
    """AdamW or Adafactor (``t["opt"]``) at a constant ``t["spec"]["lr"]``
    from either package's ``optim`` / ``schedules`` (``mod``)."""
    lr = mod.schedules.constant(t["spec"]["lr"])
    if t["opt"] == "adafactor":
        return mod.optim.adafactor(lr, min_dim_factored=t["min_dim"])
    return mod.optim.adamw(lr)


def port_tp_train(group, rank, world, args):
    """On a ``args["shape"]`` mesh: each case's loss and whole gradients
    (``[arch, flags]``, both ``PerfFlags`` on or off), the round trip of
    ``shard_params`` through ``params_to_numpy``, and each trainer of
    ``args["trainers"]`` resumed from its checkpoint directory."""
    import types

    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.train import optim, schedules
    from repro_torch.train import step as S
    from repro_torch.train.loop import Trainer, TrainerConfig
    mesh = make_mesh(tuple(args["shape"]), ("data", "model"))
    n_dp, r_dp = mesh.sizes["data"], mesh.coords["data"]
    out = {"metrics": {}, "round_trip": {}, "trainers": {}}
    arrays = {}
    for arch, flags in args["cases"]:
        ctx = sharding.make_ctx(mesh, flags=sharding.PerfFlags(flags, flags))
        cfg, lib, model, tree = _port_model(args["inputs"], arch)
        sharding.shard_params(model, ctx)
        if not flags:
            back, want = _flat(lib.params_to_numpy(model)), _flat(tree)
            out["round_trip"][arch] = sorted(back) == sorted(want) and all(
                back[k].dtype == want[k].dtype
                and np.array_equal(back[k], want[k]) for k in want)
        moe.shard_experts(model, ctx.dp_group)
        batch = _load(args["inputs"], f"batch_{arch}.npz")
        b = TP_B // n_dp
        local = {k: torch.from_numpy(v[r_dp * b:(r_dp + 1) * b])
                 for k, v in batch.items()}
        _, metrics, grads = S.value_and_grad(model, local, ctx.dp_group)
        grads = S.reduce_grads(grads, S.expert_sharded(model), ctx.dp_group)
        whole = _whole_grads(model, grads)
        key = f"{arch}|{int(flags)}"
        out["metrics"][key] = {k: float(v) for k, v in metrics.items()}
        if rank == 0:
            arrays.update({f"{key}|{k}": v for k, v in _flat(whole).items()})
    mods = types.SimpleNamespace(optim=optim, schedules=schedules)
    for t in args.get("trainers", []):
        cfg = registry.get(t["spec"]["arch"]).smoke()
        tcfg = TrainerConfig(steps=t["steps"], log_every=1,
                             ckpt_every=t.get("ckpt_every", 100),
                             ckpt_dir=t["ckpt"], resume=True)
        tr = Trainer(cfg, mesh, _optimizer(mods, t), _data(cfg, t["spec"]),
                     tcfg, device="cpu")
        hist = tr.run()
        out["trainers"][t["name"]] = {
            "losses": [h["loss"] for h in hist], "start": tr.start_step}
    return out, arrays


def _layer_fns(L, M, ctx_kw, arange):
    """kind -> fn(x, block params, blk, cfg) of either package (``L`` its
    layers module, ``M`` its moe module); ``ctx_kw(fn)`` passes the
    context the package's way, ``arange`` makes its positions."""
    def attn(x, p, blk, cfg):
        return ctx_kw(L.attention)(x, p["attn"], blk, cfg,
                                   positions=arange(x.shape[1]))
    return {
        "attn_a": attn, "attn_b": attn, "attn_c": attn,
        "attn_c_ragged": attn,
        "mlp": lambda x, p, blk, cfg: ctx_kw(L.mlp)(x, p["mlp"], cfg),
        "ssd": lambda x, p, blk, cfg: ctx_kw(L.ssd_mixer)(
            x, p["ssd"], blk.ssd, cfg)[0],
        "rglru": lambda x, p, blk, cfg: ctx_kw(L.rglru_mixer)(
            x, p["rglru"], blk.rglru, cfg)[0],
        "moe": lambda x, p, blk, cfg: ctx_kw(M.moe)(x, p["moe"], blk.moe,
                                                    cfg)[0],
        "moe_shared": lambda x, p, blk, cfg: ctx_kw(M.moe)(
            x, p["moe"], blk.moe, cfg)[0]}


def layer_block(cfg, kind: str) -> int:
    """The index (execution order) of ``cfg``'s first block of ``kind``."""
    want = {"ssd": "ssd", "rglru": "rglru"}.get(kind, "attn")
    for i, b in enumerate(cfg.all_blocks()):
        if kind.startswith("moe") and b.moe is not None:
            return i
        if kind == "mlp" and b.d_ff and b.moe is None:
            return i
        if kind not in ("mlp",) and not kind.startswith("moe") \
                and b.kind == want:
            return i
    raise ValueError(kind)


def layer_inputs(cfg, kind: str, B: int = 2):
    """(x, cotangent) of a layer case, from ``default_rng(11)``: (B, S)
    with S of :data:`LAYER_S`, else ``TP_S``."""
    rng = np.random.default_rng(11)
    S = LAYER_S.get(kind, TP_S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x, rng.standard_normal(x.shape).astype(np.float32)


def port_layer(cfg, model, kind: str, ctx=None):
    """The port's layer case on ``model``'s block: (y, dx, whole block
    parameter gradients as a flat dict)."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    i = layer_block(cfg, kind)
    blk, block = cfg.all_blocks()[i], model.blocks[i]
    xs, cot = layer_inputs(cfg, kind)
    x = torch.from_numpy(xs).requires_grad_(True)
    block.requires_grad_(True)

    def with_ctx(fn):
        return (lambda *a, **k: fn(*a, ctx=ctx, **k)) if ctx else fn
    fn = _layer_fns(L, M, with_ctx, torch.arange)[kind]
    y = fn(x, _Attr(block), blk, cfg)
    names, leaves = zip(*block.named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                [x, *leaves], allow_unused=True)
    whole = {}
    for name, p, g in zip(names, leaves, grads[1:]):
        g = torch.zeros_like(p) if g is None else g
        whole[name.replace(".", "/")] = _np(sharding.gather_leaf(
            g, sharding.param_splits(p)))
    return _np(y), _np(grads[0]), whole


class _Attr:
    """A block module read as the reference's dict of its children."""

    def __init__(self, module):
        self.module = module

    def __getitem__(self, k):
        return getattr(self.module, k)


def port_tp_layers(group, rank, world, args):
    """Every layer case of ``args["cases"]`` ([kind, arch]) over a
    ``(1, world)`` mesh; rank 0 returns y, dx and the whole parameter
    gradients (``args["plain"]``: also the case without a group, under
    ``plain|``)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    ctx = sharding.make_ctx(make_mesh((1, world), ("data", "model")))
    arrays = {}
    for kind, arch in args["cases"]:
        runs = [("", ctx)] + ([("plain|", None)] if args.get("plain")
                              else [])
        for prefix, c in runs:
            cfg, _, model, _ = _port_model(args["inputs"], arch)
            if c is not None:
                sharding.shard_params(model, c)
            y, dx, grads = port_layer(cfg, model, kind, c)
            if rank == 0:
                key = f"{prefix}{kind}|{arch}"
                arrays.update({f"{key}|y": y, f"{key}|dx": dx})
                arrays.update({f"{key}|g|{k}": v for k, v in grads.items()})
    return {}, arrays


SERVE_ARCHS = ["granite-3-2b", "gemma2-2b", "recurrentgemma-2b",
               "mamba2-1.3b", "olmoe-1b-7b", "whisper-base",
               "phi3-medium-14b"]
SERVE = dict(B=2, prompt=11, new=8)     # max_len 19: a ring padded to 20


def serve_prompts(cfg):
    rng = np.random.default_rng(5)
    return rng.integers(1, cfg.vocab_size, (SERVE["B"], SERVE["prompt"]))


def port_tp_serve(group, rank, world, args):
    """Prefill and ``SERVE["new"]`` greedy decode steps of each arch on a
    ``(1, world)`` mesh through ``Engine`` (whisper: encode, the cross
    cache, the prompt decoded token by token); every rank's tokens, rank
    0's logits.  ``args["window"]``: an engine's tokens and its teacher
    forcing on a prompt that crosses gemma2's window."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec, lm
    from repro_torch.serve.engine import Engine, ServeConfig
    mesh = make_mesh((1, world), ("data", "model"))
    ctx = sharding.make_ctx(mesh)
    out, arrays = {"tokens": {}}, {}
    P, N = SERVE["prompt"], SERVE["new"]
    for arch in args["archs"]:
        cfg, lib, model, _ = _port_model(args["inputs"], arch)
        prompts = torch.from_numpy(serve_prompts(cfg))
        steps = []
        with torch.no_grad():
            if lib is encdec:
                sharding.shard_params(model, ctx)
                frames = torch.from_numpy(_load(
                    args["inputs"], f"batch_{arch}.npz")["frontend_embeds"]
                    [:SERVE["B"]])
                cache = encdec.init_cache(cfg, SERVE["B"], P + N, "cpu", ctx)
                cache = encdec.precompute_cross_cache(
                    model, encdec.encode(model, frames), cache)
                for i in range(P):
                    logits, cache = encdec.decode_step(
                        model, prompts[:, i:i + 1], cache, i)
                step = encdec.decode_step
            else:
                eng = Engine(cfg, model, ServeConfig(), device="cpu",
                             mesh=mesh)
                logits, cache = eng.prefill(prompts, P + N)
                step = lm.decode_step
            steps.append(logits)
            toks = [logits.argmax(-1)]
            for t in range(N):
                logits, cache = step(model, toks[-1][:, None], cache, P + t)
                steps.append(logits)
                toks.append(logits.argmax(-1))
        out["tokens"][arch] = torch.stack(toks, 1).tolist()
        if rank == 0:
            arrays[arch] = _np(torch.stack(steps))
    if args.get("window"):
        cfg, _, model, _ = _port_model(args["inputs"], "gemma2-2b")
        eng = Engine(cfg, model, ServeConfig(max_new_tokens=10),
                     device="cpu", mesh=mesh)
        prompt = [3, 1, 4, 1, 5]
        got = eng.generate([prompt])[0]
        seq, forced = list(prompt), []
        with torch.no_grad():
            for _ in range(10):
                h, _ = lm.forward(eng.model, torch.tensor([seq]))
                forced.append(int(lm.logits_from_h(eng.model, h)[0, -1]
                                  .argmax()))
                seq.append(forced[-1])
        out["window"] = {"engine": got, "forced": forced}
    return out, arrays


SCENARIOS = {"collectives": port_collectives, "mesh": port_mesh,
             "trainer": port_trainer,
             "olmoe_loss": port_olmoe_loss, "islands": port_islands,
             "tp_train": port_tp_train, "tp_layers": port_tp_layers,
             "tp_serve": port_tp_serve}


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

def _ref_mesh(shape):
    """A ("data", "model") mesh with ``Auto`` axes: ``shape`` a (data,
    model) pair, or ``n`` for (n, 1)."""
    import math

    import jax
    from jax.sharding import AxisType
    shape = (shape, 1) if isinstance(shape, int) else tuple(shape)
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=np.array(jax.devices()[:math.prod(shape)]))


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


def _ref_inputs(R, d, arch: str):
    """(cfg, model library, params, batch) of the reference from the files
    of :func:`write_inputs`."""
    import jax.numpy as jnp
    cfg = R.registry.get(arch).smoke()
    lib = R.encdec if isinstance(cfg, R.encdec.EncDecCfg) else R.lm
    params = _nest({k: jnp.asarray(v) for k, v in
                    _load(d, f"params_{arch}.npz").items()})
    batch = {k: jnp.asarray(v) for k, v in
             _load(d, f"batch_{arch}.npz").items()}
    return cfg, lib, params, batch


def ref_tp_train(R, n, d, args):
    """The reference's jitted ``value_and_grad`` of each case on an
    ``args["shape"]`` mesh (``PerfFlags(True, True)`` where the case asks),
    and each trainer resumed from a copy of its checkpoint directory."""
    import dataclasses
    import shutil
    import types

    import jax
    mesh = _ref_mesh(tuple(args["shape"]))
    out, arrays = {"metrics": {}, "trainers": {}}, {}
    for arch, flags in args["cases"]:
        cfg, lib, params, batch = _ref_inputs(R, args["inputs"], arch)
        ctx = R.sharding.make_ctx(mesh)
        if flags:
            ctx = dataclasses.replace(ctx, flags=R.layers.PerfFlags(True,
                                                                    True))
        (_, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: lib.loss_fn(p, b, cfg, ctx), has_aux=True))(
            params, batch)
        key = f"{arch}|{int(flags)}"
        out["metrics"][key] = {k: float(v) for k, v in m.items()}
        arrays.update({f"{key}|{k}": v for k, v in
                       _flat(jax.tree.map(np.asarray, g)).items()})
    mods = types.SimpleNamespace(optim=R.optim, schedules=R.schedules)
    for t in args.get("trainers", []):
        spec = t["spec"]
        cfg = R.registry.get(spec["arch"]).smoke()
        run = d / t["name"]
        shutil.copytree(t["ckpt"], run)
        data = R.train_data.SyntheticLM(R.train_data.LMTaskConfig(
            vocab_size=cfg.vocab_size, seq_len=spec["seq"],
            global_batch=spec["batch"], seed=spec["seed"]))
        tcfg = R.loop.TrainerConfig(steps=t["steps"], log_every=1,
                                    ckpt_dir=str(run), resume=True)
        hist = R.loop.Trainer(cfg, mesh, _optimizer(mods, t), data,
                              tcfg).run()
        out["trainers"][t["name"]] = [h["loss"] for h in hist]
    return out, arrays


def _ref_block(tree: dict, cfg, i: int) -> dict:
    """The reference's parameters of block ``i`` (execution order)."""
    P, J = len(cfg.prefix), len(cfg.pattern)
    if i < P:
        return tree[f"pre{i}"]
    r, j = divmod(i - P, J)
    import jax
    return jax.tree.map(lambda x: x[r], tree["pattern"][f"blk{j}"])


def ref_tp_layers(R, n, d, args):
    """Every layer case of ``args["cases"]`` under ``jit`` on a (1, n)
    mesh: y, dx and the block's parameter gradients of ``sum(y * cot)``."""
    import jax
    import jax.numpy as jnp
    ctx = R.sharding.make_ctx(_ref_mesh((1, n)))
    fns = _layer_fns(R.layers, R.moe, lambda fn: (
        lambda *a, **k: fn(*a, ctx, **k)), jnp.arange)
    arrays = {}
    for kind, arch in args["cases"]:
        cfg, _, params, _ = _ref_inputs(R, args["inputs"], arch)
        i = layer_block(cfg, kind)
        blk, p = cfg.all_blocks()[i], _ref_block(params, cfg, i)
        x, cot = (jnp.asarray(a) for a in layer_inputs(cfg, kind))
        fn = fns[kind]

        def obj(x, p):
            y = fn(x, p, blk, cfg)
            return jnp.sum(y * cot), y
        (_, y), (dx, dp) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(x, p)
        key = f"{kind}|{arch}"
        arrays.update({f"{key}|y": np.asarray(y), f"{key}|dx": np.asarray(dx)})
        arrays.update({f"{key}|g|{k}": v for k, v in
                       _flat(jax.tree.map(np.asarray, dp)).items()})
    return {}, arrays


def _place(R, cfg, pre, B: int, prompt_len: int, max_len: int):
    """The reference's prefill cache in its ``init_cache`` buffers of
    ``max_len`` positions: attention K/V at slot ``p % W`` (the engine's
    own placement has reference faults 1 and 2), recurrent states as
    they are."""
    import jax
    import jax.numpy as jnp
    buf = R.lm.init_cache(cfg, B, max_len)

    def one(path, z, c):
        if getattr(path[-1], "key", None) not in ("k", "v"):
            return c
        W, m = z.shape[-3], c.shape[-3]
        slots = np.arange(prompt_len - m, prompt_len) % W
        return jnp.asarray(z).at[..., slots, :, :].set(c)
    return jax.tree_util.tree_map_with_path(one, buf, pre)


def ref_tp_serve(R, n, d, args):
    """Each arch's prefill and greedy decode loop (``lm.prefill`` /
    ``lm.decode_step``; whisper: encode, the cross cache, the prompt
    token by token) under ``jit`` on a (1, n) mesh: tokens and logits."""
    import jax
    import jax.numpy as jnp
    ctx = R.sharding.make_ctx(_ref_mesh((1, n)))
    P, N, B = SERVE["prompt"], SERVE["new"], SERVE["B"]
    out, arrays = {"tokens": {}}, {}
    for arch in args["archs"]:
        cfg, lib, params, batch = _ref_inputs(R, args["inputs"], arch)
        prompts = jnp.asarray(serve_prompts(cfg).astype(np.int32))
        steps = []
        if lib is R.encdec:
            enc = jax.jit(lambda p, f: lib.encode(p, f, cfg, ctx))(
                params, batch["frontend_embeds"][:B])
            cache = lib.precompute_cross_cache(
                params, enc, cfg, ctx, lib.init_cache(cfg, B, P + N))
            dec = jax.jit(lambda p, t, c, i: lib.decode_step(
                p, t, c, i, cfg, ctx))
            for i in range(P):
                logits, cache = dec(params, prompts[:, i:i + 1], cache,
                                    jnp.int32(i))
        else:
            logits, pre = jax.jit(lambda p, t: lib.prefill(p, t, cfg, ctx))(
                params, prompts)
            cache = _place(R, cfg, pre, B, P, P + N)
            dec = jax.jit(lambda p, t, c, i: lib.decode_step(
                p, t, c, i, cfg, ctx))
        steps.append(logits)
        toks = [jnp.argmax(logits, -1)]
        for t in range(N):
            logits, cache = dec(params, toks[-1][:, None], cache,
                                jnp.int32(P + t))
            steps.append(logits)
            toks.append(jnp.argmax(logits, -1))
        out["tokens"][arch] = np.stack([np.asarray(t) for t in toks],
                                       1).tolist()
        arrays[arch] = np.stack([np.asarray(s_) for s_ in steps])
    return out, arrays


REFERENCE = {"compressed": ref_compressed, "trainers": ref_trainers,
             "olmoe_loss": ref_olmoe_loss, "tp_train": ref_tp_train,
             "tp_layers": ref_tp_layers, "tp_serve": ref_tp_serve}


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
