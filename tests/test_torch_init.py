"""The port's weights from a seed alone, against the JAX package's, on the
CPU.

* ``lm.init_params`` / ``encdec.init_params`` from ``prng.PRNGKey(s)``
  equal the reference's ``init_params(cfg, jax.random.PRNGKey(s))`` leaf
  for leaf, bit for bit (through ``params_to_numpy``), for every
  registry arch's smoke config at seeds 0 and 1, in its own
  ``param_dtype`` and in bfloat16.
* So nothing needs carrying across: granite's smoke ``Trainer(seed=0)``
  follows the reference's ``Trainer(seed=0)`` over 12 steps within
  ``CURVE_RTOL`` (the float32 sums of ``tests/test_torch_train_lm.py``),
  and gemma2's smoke ``Engine`` on ``init_params(cfg, 0)`` emits the
  reference's tokens on ``lm.init_params(cfg, PRNGKey(0))``, greedy and
  at temperature 0.8, as does the port's ``launch.serve``.  Prompts are
  longer than the window (the reference's engine mis-sizes window caches
  otherwise, ``ROADMAP.md`` reference fault 2).

The reference runs on a one-device mesh with ``Auto`` axes
(``_repro_reference.auto_mesh``).
"""

import dataclasses

import jax
import numpy as np
import pytest

from _repro_reference import auto_mesh, reference
from _torch_models import port_cfg
from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import encdec, lm
from repro_torch.models.layers import map_layout
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import data as data_lib
from repro_torch.train import optim, schedules
from repro_torch.train.loop import Trainer, TrainerConfig

CURVE_RTOL = 1e-5
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 9],
           [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
           [1, 4, 1, 4, 2, 1, 3, 5, 6, 2, 3, 7]]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("dtype", ["own", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_init_params_match_reference_bit_for_bit(ref, arch, seed, dtype):
    cfg = ref.registry.get(arch).smoke()
    if dtype != "own":
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    key = jax.random.PRNGKey(seed)
    if registry.get(arch).is_encdec:
        lib, rlib = encdec, ref.encdec
        pcfg = encdec.EncDecCfg(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(cfg)})
    else:
        lib, rlib, pcfg = lm, ref.lm, port_cfg(cfg)
    want = dict(_leaves(jax.tree.map(np.asarray, rlib.init_params(cfg, key))))
    model = lib.init_params(pcfg, prng.PRNGKey(seed), "cpu")
    got = dict(_leaves(lib.params_to_numpy(model)))
    dtypes = dict(_leaves(map_layout(
        lambda x: (x[0] if isinstance(x, tuple) else x).dtype,
        lib.param_layout(model))))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        assert str(dtypes[path]).split(".")[1] == str(w.dtype), path
        np.testing.assert_array_equal(      # float32 holds bfloat16 exactly
            got[path].view(np.int32), w.astype(np.float32).view(np.int32),
            err_msg=path)


def test_an_int_key_is_its_prngkey():
    cfg = registry.get("granite-3-2b").smoke()
    a = lm.params_to_numpy(lm.init_params(cfg, 3, "cpu"))
    b = lm.params_to_numpy(lm.init_params(cfg, prng.PRNGKey(3), "cpu"))
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


# ------------------------------------------------------------- trainer

def _data(cfg, lib):
    return lib.SyntheticLM(lib.LMTaskConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=1))


def test_trainer_from_a_seed_follows_the_reference(ref, tmp_path):
    """Granite's smoke config, AdamW at lr 2e-3, 12 steps from seed 0 in
    each package, no checkpoint between them."""
    cfg = ref.registry.get("granite-3-2b").smoke()
    want = ref.loop.Trainer(
        cfg, auto_mesh(), ref.optim.adamw(ref.schedules.constant(2e-3)),
        _data(cfg, ref.train_data), ref.loop.TrainerConfig(
            steps=12, log_every=4, ckpt_dir=str(tmp_path / "ref"),
            seed=0)).run()
    pcfg = registry.get("granite-3-2b").smoke()
    got = Trainer(pcfg, None, optim.adamw(schedules.constant(2e-3)),
                  _data(pcfg, data_lib), TrainerConfig(
                      steps=12, log_every=4, ckpt_dir=str(tmp_path / "port"),
                      seed=0), device="cpu").run()
    assert [h["step"] for h in got] == [h["step"] for h in want] \
        == [4, 8, 12]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=CURVE_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]


# -------------------------------------------------------------- engine

def _reference_engine(ref, arch, **scfg):
    """The reference's engine on ``lm.init_params(cfg, PRNGKey(0))``."""
    cfg = ref.registry.get(arch).smoke()
    params = ref.lm.init_params(cfg, jax.random.PRNGKey(0))
    return ref.engine.Engine(cfg, params, auto_mesh(),
                             ref.engine.ServeConfig(**scfg))


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "seed": 1}],
                         ids=["greedy", "temperature"])
def test_engine_from_a_seed_emits_the_reference_tokens(ref, sampling):
    cfg = registry.get("gemma2-2b").smoke()
    assert min(map(len, PROMPTS)) > max(b.window or 0
                                        for b in cfg.all_blocks())
    scfg = dict(max_new_tokens=6, **sampling)
    want = _reference_engine(ref, "gemma2-2b", **scfg).generate(PROMPTS)
    got = Engine(cfg, lm.init_params(cfg, 0, "cpu"), ServeConfig(**scfg),
                 device="cpu").generate(PROMPTS)
    assert got == want


def test_serve_launcher_emits_the_reference_tokens(ref, capsys):
    """``launch.serve --seed 0``: the JAX package's launcher's weights and
    prompts, so the reference's engine's tokens."""
    args = ["--arch", "gemma2-2b", "--smoke", "--batch", "2",
            "--prompt-len", "12", "--new-tokens", "5", "--device", "cpu"]
    assert serve.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    _, _, prompts = serve.build(serve.parse_args(args))
    want = _reference_engine(ref, "gemma2-2b",
                             max_new_tokens=5).generate(prompts)
    want = [[int(t) for t in o] for o in want]
    assert lines[1:] == [f"  sample {i}: {o}" for i, o in enumerate(want)]
