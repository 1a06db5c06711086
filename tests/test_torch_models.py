"""The port's model configurations, layers, KV cache and dense transformer
(``repro_torch.models``, ``repro_torch.configs``) against the JAX package,
on the CPU.

* every assigned architecture's configuration, its reduced form and its
  parameter counts equal the reference's, and so do the shapes of its
  reduced model's parameters, each layer stack's included (all six
  families; ``tests/test_torch_families.py`` runs moe, hybrid, vlm and
  audio);
* rmsnorm, layernorm, RoPE, masking, the naive, chunked and flash
  attention branches, the MLPs and the logits with a padded vocab;
* the KV cache: int8 quantize and dequantize exactly equal, ring writes;
* dense ``forward``, ``prefill`` and ``decode_step`` of reduced
  ``smollm-360m`` and ``tinyllama-1.1b`` on the reference's weights
  (``convert.params_from_numpy``), with a ring that wraps and an int8
  cache.

Inputs are seeded numpy draws given to both packages. Tolerance: float32
end to end, the two differ only in summation order and in the last bits of
``exp``/``pow``: 1e-5 on a layer, 1e-4 on a whole model's logits. The int8
quantization is held exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import kv_cache as jkv  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import (config, kv_cache, layers,  # noqa: E402
                                transformer)

RULES = Rules.disabled()
CPU = "cpu"


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, 1, shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_config_and_counts_match_reference(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        assert c.padded_vocab() == j.padded_vocab()
        assert c.resolved_head_dim() == j.resolved_head_dim()
        assert config.param_count(c) == jconfig.param_count(j)
        assert config.active_param_count(c) == jconfig.active_param_count(j)
    assert registry.ARCHS == jregistry.ARCHS
    assert config.SHAPES == {k: config.ShapeConfig(**dataclasses.asdict(v))
                             for k, v in jconfig.SHAPES.items()}


@pytest.mark.parametrize("arch", jregistry.ARCHS)
def test_param_shapes_match_reference(arch):
    """Every parameter of the reduced model, with each layer stack's
    ``nn.ModuleList`` indices read back as the reference's leading stacked
    dims (``layers`` [L], whisper's ``enc_layers`` and ``dec_layers``, the
    vlm's ``groups.self`` [G, S] and ``groups.cross`` [G])."""
    cfg = registry.get_config(arch).reduced()
    jp = jax.eval_shape(lambda: jregistry.init_params(
        jax.random.PRNGKey(0), jregistry.get_config(arch).reduced()))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    model = registry.init_params(cfg, seed=0, device=CPU)
    stacked = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        assert p.dtype == torch.float32 and not p.requires_grad
        key = "/".join(x for x in parts if not x.isdigit())
        stacked.setdefault(key, []).append(
            ([int(x) for x in parts if x.isdigit()], tuple(p.shape)))
    got = {}
    for key, entries in stacked.items():
        assert len({shape for _, shape in entries}) == 1, key
        lead = tuple(max(idx[d] for idx, _ in entries) + 1
                     for d in range(len(entries[0][0])))
        got[key] = lead + entries[0][1]
    assert got == {k: tuple(v) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    x = _normal((2, 5, 16), seed=1, scale=3.0)
    scale = _normal((16,), seed=2)
    bias = _normal((16,), seed=3)
    p = layers.Params(norm_scale=torch.from_numpy(scale),
                      norm_bias=torch.from_numpy(bias))
    _close(layers.rmsnorm(p, torch.from_numpy(x), 1e-5),
           jL.rmsnorm({"norm_scale": scale}, jnp.asarray(x), 1e-5))
    _close(layers.layernorm(p, torch.from_numpy(x), 1e-5),
           jL.layernorm({"norm_scale": scale, "norm_bias": bias},
                        jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference(theta):
    x = _normal((2, 7, 3, 16), seed=4)
    pos = np.array([0, 1, 2, 5, 11, 300, 2047])
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # one decode position, as the decode step passes it
    _close(layers.apply_rope(torch.from_numpy(x[:, :1]),
                             torch.tensor([37]), theta),
           jL.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(37)[None, None],
                         theta)[:, 0:1])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 4)])
def test_mask_and_attention_branches_match_reference(causal, window):
    B, S, H, KV, hd = 2, 12, 4, 2, 16
    q, k, v = (_normal((B, S, n, hd), seed=5 + i) for i, n in
               enumerate((H, KV, KV)))
    pos = np.arange(S) + 3
    lg = _normal((B, H, S, S), seed=9)
    _close(layers.mask_logits(torch.from_numpy(lg), torch.from_numpy(pos),
                              torch.from_numpy(pos), causal, window),
           jL.mask_logits(jnp.asarray(lg), jnp.asarray(pos), jnp.asarray(pos),
                          causal, window))
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    want = jL.attend(jq, jk, jv, jp, jp, causal=causal, window=window)
    _close(layers.attend(tq, tk, tv, tp, tp, causal=causal, window=window),
           want)
    _close(layers.attend(tq, tk, tv, tp, tp, causal=causal, window=window,
                         impl="chunked", block_k=4),
           jL.attend(jq, jk, jv, jp, jp, causal=causal, window=window,
                     impl="chunked", block_k=4))
    if not window:
        _close(layers.attend(tq, tk, tv, tp, tp, causal=causal,
                             use_flash=True), want)
    # a decode-style validity mask over the keys
    mask = np.random.default_rng(10).random((B, S)) < 0.6
    mask[:, 0] = True
    _close(layers.attend(tq[:, :1], tk, tv, tp[:1], tp, causal=False,
                         kv_mask=torch.from_numpy(mask)),
           jL.attend(jq[:, :1], jk, jv, jp[:1], jp, causal=False,
                     kv_mask=jnp.asarray(mask)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    x = _normal((2, 3, 16), seed=11)
    w = {n: _normal(s, seed=12 + i, scale=0.3) for i, (n, s) in enumerate(
        (("w1", (16, 32)), ("w2", (32, 16)), ("w3", (16, 32))))}
    if act != "silu":
        del w["w3"]
    p = layers.Params(**{n: torch.from_numpy(a) for n, a in w.items()})
    _close(layers.mlp_apply(p, torch.from_numpy(x), act),
           jL.mlp_apply(w, jnp.asarray(x), act, RULES))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "smollm-360m"])
def test_embed_and_logits_match_reference(arch):
    """hymba's reduced vocab (128) pads to 256 with an untied head (the
    tail is masked); smollm ties its embedding."""
    cfg = registry.get_config(arch).reduced()
    jcfg = jregistry.get_config(arch).reduced()
    jp = jL.embedding_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.device_get({**jp, "layers": {}}), dataclasses.
                           replace(cfg, n_layers=0), CPU)
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 5))
    x = layers.embed(tp, torch.from_numpy(toks), cfg)
    _close(x, jL.embed(jp, jnp.asarray(toks), jcfg, RULES))
    lg = layers.logits(tp, x, cfg)
    want = jL.logits(jp, jnp.asarray(x.numpy()), jcfg, RULES)
    assert lg.shape == want.shape
    _close(lg, want)


@pytest.mark.parametrize("arch", ["whisper-tiny", "olmoe-1b-7b"])
def test_bfloat16_logits_mask_the_padded_vocab_as_the_reference(arch):
    """At bfloat16 (the published configs' dtype) the padded vocab tail
    takes float32's min cast to bfloat16, -inf, as in the reference:
    whisper's 51865 pads to 52224, olmoe's 50304 to 50432."""
    cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                              vocab=registry.get_config(arch).vocab,
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jregistry.get_config(arch).reduced(),
                               vocab=cfg.vocab, dtype="bfloat16")
    assert cfg.padded_vocab() > cfg.vocab
    jp = jL.embedding_init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_numpy(jax.device_get({**jp, "layers": {}}), dataclasses.
                           replace(cfg, n_layers=0), CPU)
    x = _normal((2, 3, cfg.d_model), seed=15)
    lg = layers.logits(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    want = jL.logits(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg, RULES)
    assert lg.dtype == torch.bfloat16
    assert bool(torch.isneginf(lg[..., cfg.vocab:]).all())
    np.testing.assert_array_equal(_np(lg[..., cfg.vocab:]),
                                  _np(want[..., cfg.vocab:]))
    _close(lg[..., :cfg.vocab], want[..., :cfg.vocab], 2e-2)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def test_int8_quantize_and_dequantize_exact():
    x = _normal((3, 7, 2, 16), seed=14, scale=2.5)
    x[0, 0, 0] = 0.0                                  # amax 0: scale floor
    q, s = kv_cache.quantize(torch.from_numpy(x))
    jq, js = jkv.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        kv_cache.dequantize(q, s, torch.float32).numpy(),
        np.asarray(jkv.dequantize(jq, js, jnp.float32)))


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ring_writes_match_reference(kv_dtype):
    cfg = dataclasses.replace(registry.get_config("smollm-360m").reduced(),
                              kv_dtype=kv_dtype)
    jcfg = dataclasses.replace(jregistry.get_config("smollm-360m").reduced(),
                               kv_dtype=kv_dtype)
    cache = kv_cache.make_cache(cfg, 1, 2, 8, CPU)
    jcache = jkv.make_cache(jcfg, 1, 2, 8)
    layer = kv_cache.layer_slices(cache, 0)
    jlayer = jkv.LayerKV(*(None if a is None else a[0] for a in
                           jkv.layer_slices(jcache)))
    # writes of 1, 3 and 8 tokens; a start past the end moves back
    for i, (n, pos) in enumerate(((1, 0), (3, 5), (1, 9), (3, 14), (8, 3))):
        kn = _normal((2, n, 2, 16), seed=20 + i)
        vn = _normal((2, n, 2, 16), seed=40 + i)
        layer = kv_cache.write(layer, torch.from_numpy(kn),
                               torch.from_numpy(vn), pos)
        jlayer = jkv.write(jlayer, jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(pos, jnp.int32))
        for g, w in zip(layer, jlayer):
            if g is not None:
                np.testing.assert_array_equal(_np(g), _np(w))
        for g, w in zip(kv_cache.read(layer, torch.float32),
                        jkv.read(jlayer, jnp.float32)):
            np.testing.assert_array_equal(_np(g), _np(w))
    assert cache.k.data_ptr() == layer.k.data_ptr()   # written in place
    with pytest.raises(ValueError, match="capacity"):
        kv_cache.write(layer, torch.zeros(2, 9, 2, 16),
                       torch.zeros(2, 9, 2, 16), 0)


# ---------------------------------------------------------------------------
# the dense transformer
# ---------------------------------------------------------------------------

DENSE = ["smollm-360m", "tinyllama-1.1b"]


@pytest.fixture(scope="module")
def dense_models():
    out = {}
    for arch in DENSE:
        jcfg = jregistry.get_config(arch).reduced()
        jp = jregistry.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = registry.get_config(arch).reduced()
        out[arch] = (cfg, jcfg, jp,
                     params_from_numpy(jax.device_get(jp), cfg, CPU))
    return out


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(dense_models, arch):
    cfg, jcfg, jp, tp = dense_models[arch]
    toks = _tokens(cfg, 2, 12)
    want = jT.forward(jp, jnp.asarray(toks), jcfg, RULES, remat=False)
    for use_flash in (False, True):
        _close(transformer.forward(tp, torch.from_numpy(toks), cfg,
                                   use_flash=use_flash), want, 1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(dense_models, arch):
    cfg, jcfg, jp, tp = dense_models[arch]
    toks = _tokens(cfg, 2, 11, seed=2)
    want, jcache = jT.prefill(jp, jnp.asarray(toks), jcfg, RULES, capacity=16)
    for use_flash in (False, True):
        got, cache = transformer.prefill(tp, torch.from_numpy(toks), cfg,
                                         capacity=16, use_flash=use_flash)
        _close(got, want, 1e-4)
        assert cache.pos == int(jcache.pos) == 11
        _close(cache.k, jcache.k, 1e-4)
        _close(cache.v, jcache.v, 1e-4)


@pytest.mark.parametrize("arch,kv_dtype,capacity", [
    ("smollm-360m", "float32", 16), ("tinyllama-1.1b", "float32", 16),
    ("smollm-360m", "float32", 5),      # the ring wraps
    ("tinyllama-1.1b", "int8", 6)])
def test_decode_steps_match_reference(dense_models, arch, kv_dtype, capacity):
    cfg, jcfg, jp, tp = dense_models[arch]
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    toks = _tokens(cfg, 2, 12, seed=3)
    cache = kv_cache.make_cache(cfg, cfg.n_layers, 2, capacity, CPU)
    jcache = jkv.make_cache(jcfg, jcfg.n_layers, 2, capacity)
    for t in range(toks.shape[1]):
        want, jcache = jT.decode_step(jp, jcache, jnp.asarray(toks[:, t]),
                                      jcfg, RULES)
        got, cache = transformer.decode_step(tp, cache,
                                             torch.from_numpy(toks[:, t]), cfg)
        _close(got, want, 1e-4)
    assert cache.pos == int(jcache.pos)
    for g, w in zip(cache[:4], jcache[:4]):
        if g is not None:
            tol = 0 if g.dtype == torch.int8 else 1e-4
            np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward(dense_models, arch):
    """The reference's own serving check (tests/test_decode_parity.py), on
    the port, with the flash branch."""
    cfg, _, _, tp = dense_models[arch]
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=4))
    full = transformer.forward(tp, toks, cfg)
    lg, cache = transformer.prefill(tp, toks[:, :11], cfg, capacity=16,
                                    use_flash=True)
    _close(lg, full[:, 10], 2e-4)
    lg, _ = transformer.decode_step(tp, cache, toks[:, 11], cfg)
    _close(lg, full[:, 11], 2e-4)
