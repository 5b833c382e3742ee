"""The port's serving engine (``repro_torch.serve.engine``) and launcher
(``repro_torch.launch.serve``) on the CPU.

* Greedy ``Engine.generate`` equals the JAX package's ``Engine`` token
  for token on carried-across weights, for the five families of the
  reference's ``tests/test_serve.py`` (the reference on a one-device mesh
  with ``Auto`` axes), with a batch unlike the prompt length and prompts
  longer than every window: the reference's engine mis-sizes window
  caches when prompt < window < prompt + new tokens, and finds the KV
  axis by its size, which fails when batch == prompt length.
* Temperature 0.8 sampling equals the reference's on two smoke configs:
  the same key schedule and Gumbel draws (``repro_torch.core.prng``, bit
  for bit), argmax over logits that agree within float32 roundoff.
* Port only: batch == prompt length serves, and the engine equals its
  own teacher forcing (greedy argmax of ``forward`` on the growing
  sequence) where the window is crossed during decode (prompt 5, window
  8, 10 new tokens), the two regimes where the reference's engine fails.

Tokens are compared exactly; a mismatch at a near-tie of two logits would
show as one (the margins on these inputs are far above roundoff).
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from _repro_reference import auto_mesh, reference
from _torch_models import lm_pair, port_cfg
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig

FAMS = ["granite-3-2b", "gemma2-2b", "mamba2-1.3b", "recurrentgemma-2b",
        "olmoe-1b-7b"]
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 9],
           [2, 7, 1, 8, 2, 8, 1, 8, 2, 8],
           [1, 4, 1, 4, 2, 1, 3, 5, 6, 2, 3, 7]]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _engines(ref, arch, seed=0, **scfg):
    cfg = ref.registry.get(arch).smoke()
    params, model = lm_pair(ref, cfg, seed)
    want = ref.engine.Engine(cfg, params, auto_mesh(),
                             ref.engine.ServeConfig(**scfg))
    got = Engine(port_cfg(cfg), model, ServeConfig(**scfg), device="cpu")
    return want, got


@pytest.mark.parametrize("arch", FAMS)
def test_greedy_generate_matches_reference(ref, arch):
    want, got = _engines(ref, arch, max_new_tokens=5)
    out = got.generate(PROMPTS)
    assert out == want.generate(PROMPTS)
    vocab = got.cfg.vocab_size
    assert all(len(o) == 5 and all(0 <= t < vocab for t in o) for o in out)
    assert len(got.timings["step_s"]) == 4


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-2b"])
def test_temperature_sampling_matches_reference(ref, arch):
    want, got = _engines(ref, arch, max_new_tokens=6, temperature=0.8,
                         seed=1)
    out = got.generate(PROMPTS)
    assert out == want.generate(PROMPTS)
    assert out == got.generate(PROMPTS)              # same seed, same draws
    assert out != Engine(got.cfg, got.model, ServeConfig(
        max_new_tokens=6), device="cpu").generate(PROMPTS)


def _teacher_forced(model, prompt, n):
    seq, out = list(prompt), []
    for _ in range(n):
        h, _ = lm.forward(model, torch.tensor([seq]))
        nxt = int(lm.logits_from_h(model, h)[0, -1].argmax())
        out.append(nxt)
        seq.append(nxt)
    return out


@pytest.mark.parametrize("seed", [0, 2])
def test_decode_across_the_window_matches_teacher_forcing(ref, seed):
    """gemma2's smoke config (window 8): a 5-token prompt and 10 new
    tokens cross the window during decode."""
    cfg = ref.registry.get("gemma2-2b").smoke()
    _, model = lm_pair(ref, cfg, seed)
    eng = Engine(port_cfg(cfg), model, ServeConfig(max_new_tokens=10),
                 device="cpu")
    prompt = [3, 1, 4, 1, 5]
    assert eng.generate([prompt])[0] == _teacher_forced(model, prompt, 10)


def test_batch_equal_to_prompt_length():
    """granite's smoke config with 4 prompts of 4 tokens: each row equals
    its own teacher forcing."""
    cfg = registry.get("granite-3-2b").smoke()
    model = lm.init_params(cfg, 1, "cpu")
    prompts = [[5, 3, 9, 1], [2, 2, 7, 4], [8, 1, 1, 6], [4, 9, 2, 3]]
    out = Engine(cfg, model, ServeConfig(max_new_tokens=4),
                 device="cpu").generate(prompts)
    assert out == [_teacher_forced(model, p, 4) for p in prompts]


def test_launcher_runs_on_the_host(capsys):
    assert serve.main(["--arch", "recurrentgemma-2b", "--smoke", "--batch",
                       "2", "--prompt-len", "9", "--new-tokens", "3",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated 6 tokens in ")
    assert lines[1].startswith("  sample 0: [") and len(lines) == 3
    with pytest.raises(SystemExit, match="enc-dec"):
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    cfg = registry.get("granite-3-2b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, lm.init_params(cfg, 0, "cpu"), ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-3-2b", "--smoke"])


def test_serving_stack_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.models\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or "
            "n.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = {**os.environ,
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1]
                             / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
