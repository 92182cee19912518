"""The port's ten LM configs and its LM search spaces against the JAX
package's: each config's specs equal the JAX ones field by field, its
full-size parameter count (counted on ``meta``) equals ``jax.eval_shape``
of the JAX ``LM.init``, its smoke spec's forward logits match the JAX
LM's on the same weights; and each space's identity sample, and seeded
samples, give the ``ModelSpec`` the JAX ``LMSpaceBuilder`` gives.

paligemma-3b and whisper-medium run those two checks in their own files
(``test_torch_vlm.py``, ``test_torch_encdec.py``), through the helpers
here: this file stays smaller than ``tests/test_cascade.py``, which xdist
then schedules (largest file first) ahead of it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import lm_space as jlm_space  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import translate as jtranslate  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro.search import samplers as jsamplers  # noqa: E402
from repro.search import study as jstudy  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.convert import lm_from_jax  # noqa: E402
from repro_torch.core import lm_space as tlm_space  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import translate as ttranslate  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.search import samplers as tsamplers  # noqa: E402
from repro_torch.search import study as tstudy  # noqa: E402

# the eight configs of the decoder slice, then the VLM and the encoder-decoder
EIGHT = ("qwen3-1.7b", "phi4-mini-3.8b", "nemotron-4-340b", "qwen1.5-4b",
         "zamba2-2.7b", "xlstm-1.3b", "dbrx-132b", "arctic-480b")
PORTED = EIGHT + ("paligemma-3b", "whisper-medium")
SPACES = ("qwen3_like", "hybrid_like", "moe_like")
JAX_SPACES = jlm_space.__file__.replace("core/lm_space.py", "configs/spaces")
REL = 1e-5  # fp32 against fp32, sums in another order: of the max |logit|


def _assert_same(port, ref, path="spec"):
    """``port`` equals ``ref`` field by field; a field only the JAX
    dataclass has (an option the port has not yet) is at its default."""
    if dataclasses.is_dataclass(port):
        assert type(port).__name__ == type(ref).__name__, path
        names = {f.name for f in dataclasses.fields(port)}
        assert names <= {f.name for f in dataclasses.fields(ref)}, path
        for f in dataclasses.fields(ref):
            if f.name in names:
                _assert_same(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
            else:
                default = (f.default if f.default is not dataclasses.MISSING
                           else f.default_factory())
                assert getattr(ref, f.name) == default, f"{path}.{f.name}"
    elif isinstance(port, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        assert port == ref, path


def test_the_port_has_the_eight_configs():
    """The eight configs of the decoder slice are there, and with
    paligemma-3b and whisper-medium the port has every config of the JAX
    package, each with the JAX ArchConfig's fields, and each builds."""
    from repro.configs import ARCHS as JAX_ARCHS

    assert set(EIGHT) < set(ARCHS)
    assert sorted(ARCHS) == sorted(PORTED) == sorted(JAX_ARCHS)
    for name in PORTED:
        port, ref = get_arch(name), jax_get_arch(name)
        for field in ("name", "family", "batch_kind", "supports_long_context",
                      "enc_context", "prefix_tokens", "source"):
            assert getattr(port, field) == getattr(ref, field), (name, field)
        model = LM(port.spec())
        assert len(model.layers()) == port.spec().n_layers
        assert len(model.enc_layers()) == len(port.spec().encoder_layers)
    with pytest.raises(KeyError, match="available"):
        get_arch("gpt-2")


def check_specs_and_full_size_parameter_count(arch):
    """``arch``'s specs (published, long-context, smoke) equal the JAX
    package's field by field, and its full-size parameter count on
    ``meta`` equals ``jax.eval_shape`` of the JAX ``LM.init``."""
    for long_context in (False, True):
        _assert_same(get_arch(arch).spec(long_context=long_context),
                     jax_get_arch(arch).spec(long_context=long_context))
    _assert_same(get_arch(arch).smoke_spec_fn(), jax_get_arch(arch).smoke_spec_fn())
    jspec = jax_get_arch(arch).spec()
    shapes = jax.eval_shape(lambda: split(JaxLM(jspec).init(
        jax.random.PRNGKey(0), dtype=jnp.float32))[0])
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    state = LM(get_arch(arch).spec()).state_dict()
    assert all(t.is_meta for t in state.values())
    assert sum(t.numel() for t in state.values()) == want


def check_smoke_forward_logits(arch):
    """The smoke spec's forward logits (tokens only) on the JAX package's
    weights match the JAX LM's."""
    jmodel = JaxLM(jax_get_arch(arch).smoke_spec_fn())
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tmodel = lm_from_jax(get_arch(arch).smoke_spec_fn(),
                         jax.tree_util.tree_map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(0).integers(0, 512, (2, 16))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(toks)), np.float64)
    got = tmodel(torch.from_numpy(toks)).double().numpy()
    assert np.abs(got - want).max() < REL * np.abs(want).max()


@pytest.mark.parametrize("arch", EIGHT)
def test_specs_and_full_size_parameter_count_match_jax(arch):
    check_specs_and_full_size_parameter_count(arch)


@pytest.mark.parametrize("arch", EIGHT)
def test_smoke_forward_logits_match_jax(arch):
    check_smoke_forward_logits(arch)


# -- the search spaces ------------------------------------------------------------

# each space's identity point: qwen3_like's reproduces qwen3-1.7b's layers
# (the point its file documents); the others take every layer kind they range
# over, at their largest widths
IDENTITY = {
    "qwen3_like": ((2048, 151936), {
        "backbone.depth": 28, "backbone.transformer_layer.kv_heads": 8,
        "backbone.transformer_layer.d_ff": 6144}),
    "hybrid_like": ((2048, 151936), {
        "backbone.depth": 4,
        "backbone.0.op": "transformer_layer", "backbone.0.transformer_layer.kv_heads": 8,
        "backbone.0.transformer_layer.d_ff": 512, "backbone.0.transformer_layer.qk_norm": True,
        "backbone.1.op": "mamba2_layer", "backbone.1.mamba2_layer.d_state": 64,
        "backbone.1.mamba2_layer.d_head": 32,
        "backbone.2.op": "mlstm_layer", "backbone.2.mlstm_layer.heads": 4,
        "backbone.3.op": "slstm_layer", "backbone.3.slstm_layer.heads": 4}),
    "moe_like": ((2048, 151936), {
        "backbone.depth": 4, "backbone.op": "moe_layer",
        **{f"backbone.{i}.moe_layer.{k}": v for i in range(4) for k, v in (
            ("kv_heads", 8), ("d_ff", 256), ("n_experts", 8), ("top_k", 2),
            ("dense_residual", i % 2 == 0))}}),
}


def _build_both(name, params, d_model, vocab):
    """The ModelSpec each package's builder gives for the same decisions."""
    jtrial = jstudy.Study(sampler=jsamplers.RandomSampler(seed=0)).ask()
    jtrial.params.update(params)
    jarch = jtranslate.sample_architecture(
        jspace.parse_search_space_file(f"{JAX_SPACES}/{name}.yaml"), jtrial)
    ttrial = tstudy.Study(sampler=tsamplers.RandomSampler(seed=0)).ask()
    ttrial.params.update(params)
    tarch = ttranslate.sample_architecture(
        tspace.parse_search_space_file(str(tlm_space.SPACES_DIR / f"{name}.yaml")), ttrial)
    assert ttrial.params == jtrial.params  # no decision left to either sampler
    return (tlm_space.LMSpaceBuilder(d_model, vocab).build(tarch),
            jlm_space.LMSpaceBuilder(d_model, vocab).build(jarch))


@pytest.mark.parametrize("name", SPACES)
def test_identity_sample_gives_the_jax_builders_spec(name):
    (d_model, vocab), params = IDENTITY[name]
    got, want = _build_both(name, params, d_model, vocab)
    _assert_same(got, want)
    if name == "qwen3_like":  # what tests/test_lm_space.py checks of the JAX builder's
        ref = get_arch("qwen3-1.7b").spec()
        assert got.n_layers == ref.n_layers == 28
        (attn, mlp), (ref_attn, ref_mlp) = (got.layers[0].subs, ref.layers[0].subs)
        assert (attn.cfg.n_heads, attn.cfg.n_kv_heads, attn.cfg.head_dim, attn.cfg.qk_norm,
                mlp.cfg.d_ff) == (ref_attn.cfg.n_heads, ref_attn.cfg.n_kv_heads,
                                  ref_attn.cfg.head_dim, ref_attn.cfg.qk_norm, ref_mlp.cfg.d_ff)
    kinds = {sub.kind for layer in got.layers for sub in layer.subs}
    assert kinds == {"qwen3_like": {"attention", "mlp"},
                     "hybrid_like": {"attention", "mlp", "mamba2", "mlstm", "slstm"},
                     "moe_like": {"attention", "moe"}}[name]


@pytest.mark.parametrize("name", SPACES)
def test_seeded_samples_give_the_jax_builders_spec_and_run(name):
    """Four draws of the JAX sampler, rebuilt by both packages at a smoke
    width: equal specs, and the port's LM runs each to finite logits."""
    space = jspace.parse_search_space_file(f"{JAX_SPACES}/{name}.yaml")
    study = jstudy.Study(sampler=jsamplers.RandomSampler(seed=1))
    for _ in range(4):
        trial = study.ask()
        jtranslate.sample_architecture(space, trial)
        got, want = _build_both(name, dict(trial.params), 64, 256)
        _assert_same(got, want)
        model = LM(got).init(torch.Generator().manual_seed(0))
        logits = model(torch.zeros((1, 8), dtype=torch.long))
        assert logits.shape == (1, 8, 256) and torch.isfinite(logits).all()


def test_spaces_are_copies_of_the_jax_spaces():
    for name in SPACES:
        port = (tlm_space.SPACES_DIR / f"{name}.yaml").read_text()
        with open(f"{JAX_SPACES}/{name}.yaml") as f:
            assert port == f.read()
