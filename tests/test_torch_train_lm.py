"""The port's LM training stack (``lm.loss_fn``, ``encdec.loss_fn``,
``repro_torch.train.{step,loop}``, ``repro_torch.launch.train``,
``repro_torch.configs.shapes``) against the JAX package's, on the CPU.
The reference runs on a one-device mesh with ``Auto`` axes
(``_repro_reference.auto_mesh``); weights come over through
``params_from_numpy``, trainer runs through the checkpoints the two
packages share.

Tolerances, and why:

* loss rtol ``LOSS_RTOL``, every gradient leaf within ``GRAD_ATOL`` of
  its largest entry (float32 sums in another order through the whole
  backward; measured 1.4e-7 and 3.7e-6);
* the 12-step ``Trainer`` loss curve within ``CURVE_RTOL`` of the
  reference's (the float32 differences above, carried through 12 AdamW
  steps);
* a run resumed across packages within rtol 1e-5 of its own package's
  continuous run (the reference's own resume bound,
  ``tests/test_train.py``); a port run resumed from its own checkpoint
  bit for bit.
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import auto_mesh, reference
from _torch_models import DECODER_ARCHS, np_, port_cfg
from repro_torch.configs import registry, shapes
from repro_torch.launch import train as launcher
from repro_torch.models import encdec, layers, lm
from repro_torch.train import data as data_lib
from repro_torch.train import optim, schedules
from repro_torch.train import step as S
from repro_torch.train.loop import StragglerMonitor, Trainer, TrainerConfig

LOSS_RTOL = 1e-6
GRAD_ATOL = 2e-5            # of a leaf's largest gradient
CURVE_RTOL = 1e-5
RESUME_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _case(ref, arch, B=2, S_=16, seed=11):
    """(reference cfg, reference params, port model, numpy batch)."""
    cfg = ref.registry.get(arch).smoke()
    rng = np.random.default_rng(seed)
    if arch == "whisper-base":
        params = ref.encdec.init_params(cfg, jax.random.PRNGKey(1))
        model = encdec.params_from_numpy(registry.get(arch).smoke(),
                                         jax.tree.map(np.asarray, params),
                                         "cpu")
        batch = {"frontend_embeds": rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
        F = 0
    else:
        params = ref.lm.init_params(cfg, jax.random.PRNGKey(1))
        model = lm.params_from_numpy(port_cfg(cfg),
                                     jax.tree.map(np.asarray, params), "cpu")
        F = cfg.frontend_tokens if cfg.frontend != "none" else 0
        batch = ({"frontend_embeds": rng.standard_normal(
            (B, F, cfg.d_model)).astype(np.float32)} if F else {})
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S_ - F)).astype(
        np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S_)).astype(
        np.int32)
    return cfg, params, model, batch


@pytest.mark.parametrize("arch", DECODER_ARCHS + ["whisper-base"])
def test_loss_and_grads_match_reference(ref, arch):
    """``loss_fn`` (cross entropy, z-loss, MoE router terms) and the
    gradient of every leaf, in the reference's stacked layout."""
    cfg, params, model, batch = _case(ref, arch)
    lib = ref.encdec if arch == "whisper-base" else ref.lm
    ctx = ref.sharding.make_ctx(auto_mesh())
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: lib.loss_fn(p, b, cfg, ctx), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    ptotal, pmetrics, pgrads = S.value_and_grad(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ptotal), float(total), rtol=LOSS_RTOL)
    assert sorted(pmetrics) == sorted(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(metrics[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    got = dict(_paths(pgrads))
    want = dict(_paths(jax.tree.map(np.asarray, grads)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        np.testing.assert_allclose(np_(got[k]), w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=f"{arch} {k}")


def test_params_to_numpy_and_param_tree(ref):
    """``params_to_numpy`` inverts ``params_from_numpy`` (pattern and
    enc/dec leaves stacked, bfloat16 widened exactly); ``param_tree``
    shares the model's storage, so writing the tree changes the model."""
    for arch in ("recurrentgemma-2b", "whisper-base"):
        cfg = ref.registry.get(arch).smoke()
        if arch == "whisper-base":
            tree = ref.encdec.init_params(cfg, jax.random.PRNGKey(0))
            model = encdec.params_from_numpy(
                registry.get(arch).smoke(), jax.tree.map(np.asarray, tree),
                "cpu")
            back = encdec.params_to_numpy(model)
        else:
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
            tree = ref.lm.init_params(cfg, jax.random.PRNGKey(0))
            model = lm.params_from_numpy(port_cfg(cfg), jax.tree.map(
                np.asarray, tree), "cpu")
            back = lm.params_to_numpy(model)
        want = dict(_paths(jax.tree.map(
            lambda x: np.asarray(x, np.float32), tree)))
        got = dict(_paths(back))
        assert sorted(got) == sorted(want), arch
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

        pt = S.param_tree(model)
        assert S.param_tree(model) is pt
        assert all(p.requires_grad for p in model.parameters())
        leaf = pt["dec"]["mlp"]["wi"] if arch == "whisper-base" else \
            pt["pattern"]["blk0"]["mlp"]["wi"]
        blocks = model.dec if arch == "whisper-base" else model.blocks
        with torch.no_grad():               # repeat 1 of the leaf
            leaf[1].fill_(0.25)
        owner = blocks[1].mlp if arch == "whisper-base" else \
            blocks[len(model.cfg.prefix) + len(model.cfg.pattern)].mlp
        assert bool((owner.wi == 0.25).all())


def test_matmul_f32_has_a_backward():
    """``aten::mm.dtype`` (the card's bfloat16 x bfloat16 -> float32
    product) has no derivative; ``layers._MatmulF32`` supplies one.  On
    meta tensors: the bare op's backward raises, the Function's gives
    gradients in the operands' dtypes.  Its arithmetic equals the CPU
    branch's autograd (float32 products of the float32 cotangent)."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta",
                           requires_grad=True)
    a, b = meta(6, 8), meta(8, 5)
    with pytest.raises(RuntimeError, match="derivative for aten::mm"):
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
    layers._MatmulF32.apply(a, b).sum().backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(6, 8, generator=gen).to(torch.bfloat16).requires_grad_()
    b = torch.randn(8, 5, generator=gen).to(torch.bfloat16).requires_grad_()
    g = torch.randn(6, 5, generator=gen)
    (layers.matmul_f32(a, b) * g).sum().backward()
    ctx = types.SimpleNamespace(saved_tensors=(a.detach(), b.detach()),
                                needs_input_grad=(True, True))
    ga, gb = layers._MatmulF32.backward(ctx, g)
    assert torch.equal(ga, a.grad) and torch.equal(gb, b.grad)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-base"])
def test_prefill_and_serve_steps_match_reference(ref, arch):
    """``make_prefill_step``'s last-position logits (and whisper's encoder
    output) against the reference's; ``make_serve_step`` is the model's
    ``decode_step`` without autograd."""
    from _torch_models import LOGIT_ATOL, LOGIT_RTOL
    cfg, params, model, batch = _case(ref, arch, S_=12)
    ctx = ref.sharding.make_ctx(auto_mesh())
    want = ref.step.make_prefill_step(cfg, ctx)(
        params, jax.tree.map(jnp.asarray, batch))
    pcfg = model.cfg
    got = S.make_prefill_step(pcfg)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    for w, g in zip(want[:2 if arch == "whisper-base" else 1], got):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
    assert not got[0].requires_grad
    if arch == "whisper-base":
        return
    tokens = torch.from_numpy(batch["tokens"]).long()
    _, cache = lm.prefill(model, tokens[:, :-1])
    from repro_torch.serve.engine import decode_cache
    T = tokens.shape[1] - 1
    logits, _ = S.make_serve_step(pcfg)(model, tokens[:, -1:],
                                        decode_cache(pcfg, cache, T, T + 1),
                                        T)
    full = lm.logits_from_h(model, lm.forward(model, tokens)[0])[:, -1]
    np.testing.assert_allclose(np_(logits), np_(full), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)


# --------------------------------------------------------------- trainers

def _data(cfg, data_lib_):
    return data_lib_.SyntheticLM(data_lib_.LMTaskConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=1))


def _ref_trainer(ref, ckpt, steps, ckpt_every=100, resume=False):
    """The reference's ``_mk_trainer`` recipe (tests/test_train.py)."""
    cfg = ref.registry.get("granite-3-2b").smoke()
    tcfg = ref.loop.TrainerConfig(steps=steps, log_every=4,
                                    ckpt_every=ckpt_every, ckpt_dir=ckpt,
                                    resume=resume)
    return ref.loop.Trainer(
        cfg, auto_mesh(), ref.optim.adamw(ref.schedules.constant(2e-3)),
        _data(cfg, ref.train_data), tcfg)


def _port_trainer(ckpt, steps, ckpt_every=100, resume=True):
    cfg = registry.get("granite-3-2b").smoke()
    tcfg = TrainerConfig(steps=steps, log_every=4, ckpt_every=ckpt_every,
                         ckpt_dir=ckpt, resume=resume)
    return Trainer(cfg, None, optim.adamw(schedules.constant(2e-3)),
                   _data(cfg, data_lib), tcfg, device="cpu")


def _copy(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def _loss_at(hist, step):
    return next(h["loss"] for h in hist if h["step"] == step)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Granite smoke trained 12 steps by both packages from the same
    initial state (the reference's step-0 checkpoint), and 8-step
    checkpoints of each resumed by the other.  -> {name: history}."""
    d = tmp_path_factory.mktemp("trainers")
    out = {}
    _ref_trainer(ref, str(d / "r0"), 0).run()         # step-0 checkpoint
    out["ref"] = _ref_trainer(ref, str(d / "ref"), 12).run()
    _ref_trainer(ref, str(d / "r8"), 8, ckpt_every=8).run()
    out["port"] = _port_trainer(_copy(d / "r0", d / "p0"), 12).run()
    _port_trainer(_copy(d / "r0", d / "p8"), 8, ckpt_every=8).run()
    out["port_from_ref8"] = _port_trainer(_copy(d / "r8", d / "pr8"),
                                          12).run()
    out["port_from_port8"] = _port_trainer(_copy(d / "p8", d / "pp8"),
                                           12).run()
    out["ref_from_port8"] = _ref_trainer(ref, _copy(d / "p8", d / "rp8"), 12,
                                         resume=True).run()
    out["dir"] = d
    return out


def test_trainer_loss_curve_matches_reference(runs):
    ref_curve = [(h["step"], h["loss"]) for h in runs["ref"]]
    port_curve = [(h["step"], h["loss"]) for h in runs["port"]]
    assert [s for s, _ in port_curve] == [s for s, _ in ref_curve] \
        == [4, 8, 12]
    np.testing.assert_allclose([l for _, l in port_curve],
                               [l for _, l in ref_curve], rtol=CURVE_RTOL)
    assert port_curve[-1][1] < port_curve[0][1]


def test_checkpoints_resume_across_packages(runs):
    """The reference's step-8 checkpoint resumes in the port, and the
    port's in the reference; each ends within rtol 1e-5 of its own
    package's continuous run.  The port's own kill-and-resume is bit for
    bit."""
    assert [h["step"] for h in runs["port_from_ref8"]] == [12]
    np.testing.assert_allclose(_loss_at(runs["port_from_ref8"], 12),
                               _loss_at(runs["port"], 12), rtol=RESUME_RTOL)
    np.testing.assert_allclose(_loss_at(runs["ref_from_port8"], 12),
                               _loss_at(runs["ref"], 12), rtol=RESUME_RTOL)
    assert _loss_at(runs["port_from_port8"], 12) == \
        _loss_at(runs["port"], 12)


def test_fault_recovery_restores_once(runs, tmp_path):
    """A ``RuntimeError`` from the ``fault_hook`` at step 6 restores the
    step-4 checkpoint once; the run ends on the continuous run's loss."""
    t = _port_trainer(_copy(runs["dir"] / "r0", tmp_path / "f"), 12,
                      ckpt_every=4)
    calls = {"n": 0}

    def fault(step):
        if step == 6 and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected node failure")
    t.fault_hook = fault
    hist = t.run()
    assert calls["n"] == 1 and [s for s, _ in t.recoveries] == [6]
    assert hist[-1]["step"] == 12
    assert _loss_at(hist, 12) == _loss_at(runs["port"], 12)


class _BadLabel:
    """ROADMAP's repro 2: all-one weights, and at data step 3 the first
    label -1 with weight 0 (a label outside [0, V))."""

    def __init__(self, data):
        self.data = data

    def batch(self, step):
        b = dict(self.data.batch(step))
        b["weights"] = np.ones(b["labels"].shape, np.float32)
        if step == 3:
            b["labels"] = b["labels"].copy()
            b["labels"][0, 0], b["weights"][0, 0] = -1, 0.0
        return b


def test_trainer_trains_through_an_out_of_range_label(ref, tmp_path):
    """Repro 2 of the fault the port repaired: granite's smoke trainer,
    from the reference's step-0 checkpoint, trains all 6 steps with no
    recovery, on the reference's loss curve."""
    def tcfg(lib, d, steps, resume=False):
        return lib.TrainerConfig(steps=steps, ckpt_every=2, log_every=1,
                                 ckpt_dir=str(tmp_path / d), resume=resume)

    def data(lib):
        return _BadLabel(lib.SyntheticLM(lib.LMTaskConfig(
            vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0)))
    cfg = ref.registry.get("granite-3-2b").smoke()
    opt = ref.optim.adamw(ref.schedules.constant(1e-3))
    ref.loop.Trainer(cfg, auto_mesh(), opt, data(ref.train_data),
                     tcfg(ref.loop, "r0", 0)).run()
    want = ref.loop.Trainer(cfg, auto_mesh(), opt, data(ref.train_data),
                            tcfg(ref.loop, "ref", 6)).run()
    shutil.copytree(tmp_path / "r0", tmp_path / "port")
    t = Trainer(registry.get("granite-3-2b").smoke(), None,
                optim.adamw(schedules.constant(1e-3)), data(data_lib),
                tcfg(types.SimpleNamespace(TrainerConfig=TrainerConfig),
                     "port", 6, resume=True), device="cpu")
    got = t.run()
    assert t.recoveries == []
    assert [h["step"] for h in got] == [h["step"] for h in want] \
        == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=CURVE_RTOL)
    np.testing.assert_allclose([want[0]["loss"], want[-1]["loss"]],
                               [6.3782, 6.7595], rtol=1e-4)


def test_trainer_raises_when_a_step_fails_again_after_a_restore(tmp_path):
    """A step that fails again right after its restore is no transient
    fault: the trainer raises (the reference restores forever)."""
    class BadBatch:
        def __init__(self, data):
            self.data = data

        def batch(self, step):
            if step == 3:
                raise RuntimeError("bad batch")
            return self.data.batch(step)
    cfg = registry.get("granite-3-2b").smoke()
    t = Trainer(cfg, None, optim.adamw(schedules.constant(1e-3)),
                BadBatch(data_lib.SyntheticLM(data_lib.LMTaskConfig(
                    vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                    seed=0))),
                TrainerConfig(steps=6, ckpt_every=2, log_every=1,
                              ckpt_dir=str(tmp_path / "c")), device="cpu")
    with pytest.raises(RuntimeError, match="failed again.*bad batch"):
        t.run()
    assert [s for s, _ in t.recoveries] == [3]


def test_trainer_refuses_a_mesh_and_restarts_without_checkpoint():
    cfg = registry.get("granite-3-2b").smoke()
    opt = optim.adamw(schedules.constant(2e-3))
    # a (2, 4) mesh needs 8 ranks; this process has none
    with pytest.raises(ValueError, match="needs 8 ranks"):
        Trainer(cfg, (2, 4), opt, _data(cfg, data_lib), TrainerConfig(),
                device="cpu")
    t = Trainer(cfg, (1, 1), opt, _data(cfg, data_lib),
                TrainerConfig(steps=2), device="cpu")
    t.fault_hook = lambda step: (_ for _ in ()).throw(RuntimeError("x"))
    with pytest.raises(RuntimeError, match="x"):          # no checkpoint
        t.run()


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0)
    for i in range(10):
        assert not m.record(i, 0.1)
    assert m.record(10, 1.0)
    assert len(m.events) == 1


def test_shapes_and_input_specs_match_reference(ref):
    assert registry.all_cells() == ref.registry.all_cells()
    for arch in registry.ARCH_IDS:
        got, want = registry.get(arch), ref.registry.get(arch)
        assert got.shapes == {k: shapes.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in want.shapes.items()}
        for name, spec in want.shapes.items():
            for mb in (None, 2):
                w = want.input_specs(spec, mb)
                g = got.input_specs(got.shapes[name], mb)
                assert sorted(g) == sorted(w), (arch, name)
                for k in w:
                    assert g[k].shape == tuple(w[k].shape)
                    assert str(g[k].dtype) == f"torch.{w[k].dtype}"


def test_launcher_trains_on_the_host(capsys):
    assert launcher.main(["--arch", "granite-3-2b", "--smoke", "--device",
                          "cpu", "--steps", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("final loss: ")
    with pytest.raises(SystemExit, match="decoder-only") as e:
        launcher.main(["--arch", "whisper-base", "--smoke", "--device",
                       "cpu"])
    assert "examples/" not in str(e.value)
    # minicpm trains on the WSD preset
    fn = launcher.lr_for("minicpm-2b", 1.0, 100)
    assert abs(fn(torch.tensor(30)).item() - 1.0) < 1e-6
    assert fn(torch.tensor(99)).item() < 0.1


def test_training_stack_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.train\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or "
            "n.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = {**os.environ,
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1]
                             / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
