"""The port's serving path: the same seeded traffic as the JAX package,
the same engine summary and generated tokens on the qwen3 smoke spec,
and the CLI on the CPU — and refusing to run without a card unless the
CPU is asked for."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import traffic as jtraffic  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import traffic as ttraffic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("arrival", ["burst", "uniform", "poisson"])
def test_traffic_stream_matches_jax_copy(seed, arrival):
    raw = {"seed": seed, "n_requests": 12, "arrival": arrival, "rate_rps": 16.0,
           "prompt_lens": {4: 3, 8: 1}, "gen_lens": [2, 6]}
    want = jtraffic.TrafficSpec.from_raw(raw).requests()
    got = ttraffic.TrafficSpec.from_raw(raw).requests()
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.prompt_tokens(512), b.prompt_tokens(512))


@pytest.mark.parametrize("arch, impl", [
    pytest.param("qwen3-1.7b", "xla", id="xla"),
    pytest.param("qwen3-1.7b", "pallas", id="pallas"),
    pytest.param("xlstm-1.3b", "xla", id="xlstm-1.3b-xla"),
    pytest.param("xlstm-1.3b", "pallas", id="xlstm-1.3b-pallas"),
    pytest.param("zamba2-2.7b", "xla", id="zamba2-2.7b-xla"),
    pytest.param("zamba2-2.7b", "pallas", id="zamba2-2.7b-pallas"),
    pytest.param("paligemma-3b", "xla", id="paligemma-3b-xla"),
    pytest.param("paligemma-3b", "pallas", id="paligemma-3b-pallas"),
    pytest.param("whisper-medium", "xla", id="whisper-medium-xla"),
    pytest.param("whisper-medium", "pallas", id="whisper-medium-pallas"),
])
def test_engine_matches_jax_engine(arch, impl):
    """The traffic of tests/test_serving.py's engine test: same summary,
    same generated tokens per request, for each ported arch's smoke spec."""
    # the port's helper is plain dataclass surgery and fits both specs
    jspec = tserve.swap_spec_impl(jax_get_arch(arch).smoke_spec_fn(), impl)
    tspec = tserve.swap_spec_impl(get_arch(arch).smoke_spec_fn(), impl)
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tmodel = lm_from_jax(tspec, jax.tree_util.tree_map(np.asarray, params), device="cpu")

    raw = {"seed": 2, "n_requests": 3, "arrival": "burst",
           "prompt_lens": [4, 6], "gen_lens": 3}
    max_ctx = jtraffic.TrafficSpec.from_raw(raw).max_context + 1
    jengine = jserve.ServingEngine(jmodel, params, max_batch=2, queue_limit=4,
                                   max_context=max_ctx)
    tengine = tserve.ServingEngine(tmodel, max_batch=2, queue_limit=4,
                                   max_context=max_ctx)
    want = jengine.run(jtraffic.TrafficSpec.from_raw(raw).requests())
    got = tengine.run(ttraffic.TrafficSpec.from_raw(raw).requests())
    assert got == want
    assert got["served"] == 3 and got["prefills"] == 3
    assert ([r["tokens"] for r in tengine.completed]
            == [r["tokens"] for r in jengine.completed])


def _serve_cli(*extra):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b",
         "--smoke", "--requests", "4", *extra],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_serve_cli_on_cpu():
    proc = _serve_cli("--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["served"] == 4 and out["shed"] == 0 and out["device"] == "cpu"
    assert out["prefills"] == 4 and len(out["prefill_ms"]) == 4


def test_serve_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _serve_cli()
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert proc.stdout.strip() == ""
