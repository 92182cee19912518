"""The port's program count (``hwgen.generator.program_cost``) beyond
FLOPs and bytes: the peak a CPU target counts for ``peak_bytes`` against
XLA's memory analysis, the kernels' work (``ops.kernel_work``) against
counts written out by hand from ``PERF.md``'s formulas, every call
counted by the recorder, and the work following the effective chunk."""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
pytest.importorskip("yaml")

from test_torch_modelled import BATCH, CASES, _cost, _drawn, _reference  # noqa: E402

from repro_torch.core import builder as tbuilder  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import translate as ttranslate  # noqa: E402
from repro_torch.evaluation import estimators as test  # noqa: E402
from repro_torch.hwgen import generator as tgen  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import schedule as ksched  # noqa: E402
from repro_torch.search import samplers as tsamplers  # noqa: E402
from repro_torch.search import study as tstudy  # noqa: E402

# A CPU target's peak (weights + input + the largest pair of consecutive
# activations) against XLA's memory analysis (arguments + output +
# temporaries): measured 1.00-1.16x, held to 0.9-1.25x.
PEAK_RATIO = (0.9, 1.25)


@pytest.mark.parametrize("name, i", CASES)
def test_cpu_peak_bytes_against_xla_memory_analysis(name, i):
    """On a CPU target ``peak_bytes`` is counted, not measured, and runs
    nothing: the count against XLA's memory analysis of the same program."""
    _, tm = _drawn(name, 6)[i]
    _, _, want = _reference(name, i)
    generated = tgen.generate_call_count()
    got = test.CompiledMemoryEstimator("host_cpu", batch=BATCH).estimate(tm)
    assert tgen.generate_call_count() == generated
    assert got == _cost(tm).peak_bytes
    assert PEAK_RATIO[0] <= got / want <= PEAK_RATIO[1], (got, want)


# -- the kernels' work ------------------------------------------------------------

def _nas_models(n):
    """The first ``n`` candidates of the chip smoke's NAS space at
    zamba2-2.7b's widths, built (weights unset): counting them costs
    nothing but the meta forward."""
    space = tspace.parse_search_space({
        "input": [2560, 2048], "output": 6,
        "sequence": [
            {"block": "mixer", "op_candidates": ["ssm", "attention"],
             "type_repeat": {"type": "vary_all", "depth": [1, 2]},
             "ssm": {"impl": ["pallas"], "d_state": [64], "d_head": [64], "expand": [2]},
             "attention": {"impl": ["pallas"], "heads": [32]}},
            {"block": "pool", "op_candidates": "global_avg_pool"},
            {"block": "head", "op_candidates": "linear", "linear": {"width": [64, 128]}},
        ]})
    b = tbuilder.ModelBuilder(space.input_shape, space.output_dim)
    st = tstudy.Study(sampler=tsamplers.RandomSampler(seed=0))
    return {m.arch.signature(): m
            for m in (b.build(ttranslate.sample_architecture(space, st.ask()))
                      for _ in range(n))}


# By hand, from PERF.md's formulas, at batch 4, L = 2048, fp32:
#   ssm_scan (H = 80 heads of P = 64, G = 1 group of N = 64, chunk Q = 128,
#   16 chunks): 4 * 16 * (1 * 128 * 129 * 64 + 80 * (128 * 129 * 64 + 4 *
#   128 * 64 * 64)) operations; bytes 4 * (2 * 4 * 2048 * 80 * 64 + 2 * 4 *
#   2048 * 64) + 4 * (4 * 2048 * 80 + 80 + 4 * 80 * 64 * 64).
#   flash_attention (32 heads of D = 80, non-causal, S = T = 2048): 4 * 4 *
#   32 * 80 * 2048 * 2048 operations; bytes 4 * 4 * 4 * 2048 * 32 * 80.
SSM_FLOPS = 4 * 16 * (128 * 129 * 64 + 80 * (128 * 129 * 64 + 4 * 128 * 64 * 64))
SSM_BYTES = 4 * (2 * 4 * 2048 * 80 * 64 + 2 * 4 * 2048 * 64) + 4 * (4 * 2048 * 80 + 80 + 4 * 80 * 64 * 64)
FLASH_FLOPS = 4 * 4 * 32 * 80 * 2048 * 2048
FLASH_BYTES = 4 * 4 * 4 * 2048 * 32 * 80


@pytest.mark.parametrize("signature, want", [
    ("ssm(d_head=64,d_state=64,expand=2,impl=pallas)|global_avg_pool()|linear(width=64)",
     {"ssm_scan": 1}),
    ("ssm(d_head=64,d_state=64,expand=2,impl=pallas)|ssm(d_head=64,d_state=64,expand=2,"
     "impl=pallas)|global_avg_pool()|linear(width=128)", {"ssm_scan": 2}),
    ("attention(heads=32,impl=pallas)|global_avg_pool()|linear(width=64)",
     {"flash_attention": 1}),
    ("attention(heads=32,impl=pallas)|attention(heads=32,impl=pallas)|global_avg_pool()"
     "|linear(width=64)", {"flash_attention": 2}),
])
def test_kernel_work_summed_over_calls_matches_the_hand_count(signature, want):
    """Every call counts: two ssm layers of one width make two calls under
    one recorded key, and the program's kernel operations are both."""
    model = _nas_models(8)[signature]
    cost = _cost(model, batch=4)
    calls = {}
    for c in cost.kernel_calls:
        calls[c["kernel"]] = calls.get(c["kernel"], 0) + c["calls"]
    assert calls == want
    per_call = {"ssm_scan": (SSM_FLOPS, SSM_BYTES), "flash_attention": (FLASH_FLOPS, FLASH_BYTES)}
    for c in cost.kernel_calls:
        assert (c["flops"], c["bytes"]) == per_call[c["kernel"]]
    assert cost.kernel_flops == sum(n * per_call[k][0] for k, n in want.items())


def test_the_recorder_counts_every_call_and_keeps_the_signature():
    model = _nas_models(8)[
        "ssm(d_head=64,d_state=64,expand=2,impl=pallas)|ssm(d_head=64,d_state=64,expand=2,"
        "impl=pallas)|global_avg_pool()|linear(width=128)"]
    sink = {}
    with ksched.record_kernel_calls(sink):
        tgen.meta_forward(model, (torch.empty(4, 2048, 2560, device="meta"),))
    (entry,) = sink.values()
    assert entry["calls"] == 2
    one = {k: dict(v, calls=1) for k, v in sink.items()}
    assert ksched.effective_signature(sink) == ksched.effective_signature(one)


@pytest.mark.parametrize("s, t, causal, window", [
    (512, 512, True, None), (200, 200, False, None), (128, 128, True, 32),
    (777, 777, True, 100), (64, 96, True, None)])
def test_flash_work_counts_the_masks_pairs(s, t, causal, window):
    from repro_torch.nn.attention import make_mask

    pairs = int(make_mask(s, t, causal, window).sum())
    flops, nbytes = ops.kernel_work("flash_attention", {"q": (2, s, 4, 16), "k": (2, t, 2, 16)},
                                    {"dtype": "bfloat16", "causal": causal, "window": window},
                                    None)
    assert flops == 4 * 2 * 4 * 16 * pairs
    assert nbytes == 2 * (2 * 2 * s * 4 * 16 + 2 * 2 * t * 2 * 16)


def test_modelled_terms_follow_the_effective_chunk():
    """The SSD scan's work depends on its chunk: a schedule that changes
    the effective chunk changes the count, and the cache key."""
    model = _nas_models(8)[
        "ssm(d_head=64,d_state=64,expand=2,impl=pallas)|global_avg_pool()|linear(width=64)"]
    base = _cost(model, batch=4)
    small = _cost(model, batch=4, schedules={"ssm_scan": {"chunk": 64}})
    (call,) = small.kernel_calls
    assert call["flops"] == ops.kernel_work("ssm_scan", call["shapes"], {"dtype": "float32"},
                                            ksched.KernelSchedule(chunk=64))[0]
    assert small.flops < base.flops and small.bytes_accessed == base.bytes_accessed
    assert math.isclose(base.flops - small.flops,
                        base.kernel_flops - small.kernel_flops, rel_tol=1e-12)
