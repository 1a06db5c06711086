"""The moe, hybrid, vlm and audio families of the port
(``repro_torch.models.moe``, ``hymba``, ``vlm``, ``whisper``) against the
JAX package, on the CPU, at reduced size on the reference's weights
(``convert.params_from_numpy``).

* the MoE: ``_dispatch_ffn`` and ``moe_apply`` at both granularities,
  with assignments dropped and with tied router probabilities;
  ``MoEStats.expert_load`` and ``dropped`` exactly, ``aux`` to 1e-5;
  ``moe.prefill`` (with and without the flash branch) against the
  reference's ``prefill(use_flash=False)``, logits and cache;
* hymba's chunked selective scan against the reference's and against a
  run of one-token ``_decode_ssm`` steps;
* the vlm's gated cross path with a nonzero gate and image (the gate
  starts at 0 and the ``Server``'s image is zeros, which would hide a
  broken cross-attention); whisper's ``encode``, plain and through B5's
  plain version;
* ``forward`` of olmoe-1b-7b, qwen3-moe-30b-a3b, hymba-1.5b,
  llama-3.2-vision-11b and whisper-tiny; ``registry.make_prefill_fn``;
  a ``decode_step`` sequence (hymba's wraps its ring of 16 slots) with
  each step's logits and the caches;
* ``Server.serve_batch``: the reference ``Server``'s tokens, and each
  decode step's logits, recorded on both servers;
* the launcher with ``--reduced --device cpu``.

Inputs are seeded numpy draws given to both packages. Tolerance: float32
end to end, the two differ in the order of float sums and the last bits
of ``exp``: 1e-5 on one layer's pieces, 1e-4 on a whole model's logits
and caches; integer statistics and tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import hymba as jH  # noqa: E402
from repro.models import kv_cache as jkv  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro.models import vlm as jV  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import (hymba, kv_cache, moe, vlm,  # noqa: E402
                                whisper)
from repro_torch.runtime import serve  # noqa: E402

RULES = Rules.disabled()
CPU = "cpu"
MOE = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
ARCHS = MOE + ["hymba-1.5b", "llama-3.2-vision-11b", "whisper-tiny"]
VLM_GATES = (0.8, -0.6)         # tanh-gated cross layers, nonzero


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, 1, shape)
            * scale).astype(np.float32)


def _perturb(arch, tree):
    """Move the parameters that start at a constant off it, in numpy, for
    both packages: the vlm's cross gates, hymba's per-channel decay rates
    (``a_log``, so that every channel decays at its own rate)."""
    if arch == "llama-3.2-vision-11b":
        tree["groups"]["cross"]["gate_attn"] = np.asarray(VLM_GATES,
                                                          np.float32)
    if arch == "hymba-1.5b":
        a = tree["layers"]["ssm"]["a_log"]
        tree["layers"]["ssm"]["a_log"] = _normal(a.shape, seed=7, scale=0.7)
    return tree


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, jcfg, reference params, port model), reduced."""
    out = {}
    for arch in ARCHS:
        jcfg = jregistry.get_config(arch).reduced()
        cfg = registry.get_config(arch).reduced()
        init = jax.jit(lambda key, c=jcfg: jregistry.init_params(key, c))
        tree = _perturb(arch, jax.device_get(init(jax.random.PRNGKey(0))))
        out[arch] = (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
                     params_from_numpy(tree, cfg, CPU))
    return out


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _extra(cfg, B, seed=5):
    """The family's stub-frontend input as numpy, or None: the vlm's image
    embeddings, the audio family's frames."""
    if cfg.family == "vlm":
        return _normal((B, cfg.image_tokens, cfg.d_model), seed)
    if cfg.family == "audio":
        return _normal((B, cfg.n_frames, cfg.d_model), seed)
    return None


# ---------------------------------------------------------------------------
# the MoE
# ---------------------------------------------------------------------------


def _moe_layer(models, arch, **changes):
    cfg, jcfg, jp, tp = models[arch]
    cfg = dataclasses.replace(cfg, **changes)
    jcfg = dataclasses.replace(jcfg, **changes)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    return cfg, jcfg, jl, tp.layers[0].moe


def _same_stats(got, want):
    aux, load, dropped = got
    assert load.dtype == dropped.dtype == torch.int32
    np.testing.assert_array_equal(load.numpy(), np.asarray(want[1]))
    assert int(dropped) == int(want[2])
    _close(aux, want[0])


@pytest.mark.parametrize("cap", [1, 3, 64])
def test_dispatch_ffn_matches_reference(models, cap):
    """22 tokens on 4 experts, top 2 (both MoE archs reduce to these
    shapes): capacity 1 and 3 drop assignments, 64 keeps them all."""
    cfg, jcfg, jl, tl = _moe_layer(models, "olmoe-1b-7b")
    x = _normal((22, cfg.d_model), seed=3)
    out, *stats = moe._dispatch_ffn(tl, torch.from_numpy(x), cfg, cap)
    jout, *jstats = jax.jit(lambda p, y: jM._dispatch_ffn(p, y, jcfg, cap))(
        jl, jnp.asarray(x))
    _close(out, jout)
    _same_stats(stats, jstats)
    assert (int(stats[2]) > 0) == (cap < 64)


@pytest.mark.parametrize("arch,block", [("olmoe-1b-7b", False),
                                        ("qwen3-moe-30b-a3b", True)])
def test_moe_apply_matches_reference(models, arch, block):
    """Both granularities at capacity factor 0.5, which drops."""
    cfg, jcfg, jl, tl = _moe_layer(models, arch, capacity_factor=0.5,
                                   moe_block_dispatch=block)
    x = _normal((3, 7, cfg.d_model), seed=4)
    out, stats = moe.moe_apply(tl, torch.from_numpy(x), cfg)
    jout, jstats = jax.jit(lambda p, y: jM.moe_apply(p, y, jcfg, RULES))(
        jl, jnp.asarray(x))
    _close(out, jout)
    _same_stats(stats, jstats)
    assert int(stats.dropped) > 0 and int(stats.expert_load.sum()) == 42


def test_tied_router_probabilities_pick_the_lower_experts(models):
    """A zero router gives every expert the same probability: top-k takes
    experts 0..k-1, as ``lax.top_k`` does, and the capacity drops the
    later tokens' assignments, as the reference's stable argsort does."""
    cfg, jcfg, jl, tl = _moe_layer(models, "olmoe-1b-7b")
    tl = type(tl)(**{k: v.data.clone() for k, v in tl.named_parameters()})
    tl.router.zero_()
    jl = dict(jl, router=jnp.zeros_like(jl["router"]))
    x = _normal((6, cfg.d_model), seed=8)
    out, *stats = moe._dispatch_ffn(tl, torch.from_numpy(x), cfg, 4)
    jout, *jstats = jax.jit(lambda p, y: jM._dispatch_ffn(p, y, jcfg, 4))(
        jl, jnp.asarray(x))
    _close(out, jout)
    _same_stats(stats, jstats)
    assert stats[1].tolist() == [6, 6, 0, 0] and int(stats[2]) == 4


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_matches_reference(models, arch):
    cfg, jcfg, jp, tp = models[arch]
    toks = _tokens(cfg, 2, 11, seed=2)
    want, jcache = jM.prefill(jp, jnp.asarray(toks), jcfg, RULES,
                              capacity=16, use_flash=False)
    for use_flash in (False, True):
        got, cache = moe.prefill(tp, torch.from_numpy(toks), cfg,
                                 capacity=16, use_flash=use_flash)
        _close(got, want, 1e-4)
        assert cache.pos == int(jcache.pos) == 11
        _close(cache.k, jcache.k, 1e-4)
        _close(cache.v, jcache.v, 1e-4)


# ---------------------------------------------------------------------------
# hymba's selective scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [12, 16])
def test_ssm_chunked_matches_reference_and_decode_steps(models, T):
    """T = 12 (one chunk of 6: the chunk shrinks to a divisor of T) and 16
    (two of 8), from a nonzero state and conv tail."""
    cfg, jcfg, jp, tp = models["hymba-1.5b"]
    d, N = cfg.d_model, cfg.ssm_state
    dx, w = _normal((2, T, d), 10), _normal((2, T, d), 11)
    Bm, Cm = _normal((2, T, N), 12), _normal((2, T, N), 13)
    w = 1.0 / (1.0 + np.exp(-w))                # decays in (0, 1)
    h0 = _normal((2, d, N), 14, 0.5)
    got = hymba.ssm_chunked(*map(torch.from_numpy, (dx, Bm, Cm, w, h0)),
                            cfg.ssm_chunk)
    want = jH.ssm_chunked(*map(jnp.asarray, (dx, Bm, Cm, w, h0)),
                          jcfg.ssm_chunk)
    for g, x in zip(got, want):
        _close(g, x)

    # the layer's SSM over T tokens against T one-token steps
    lp = tp.layers[0].ssm
    x = torch.from_numpy(_normal((2, T, d), 15))
    st = hymba.SSMState(torch.from_numpy(h0),
                        torch.from_numpy(_normal((2, 3, d), 16)))
    y, st_T = hymba.ssm_apply(lp, x, st, cfg)
    jy, jst = jH.ssm_apply(jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
                           jnp.asarray(x.numpy()),
                           jH.SSMState(*(jnp.asarray(s.numpy()) for s in st)),
                           jcfg, RULES)
    _close(y, jy)
    for g, w_ in zip(st_T, jst):
        _close(g, w_)
    h, tail, ys = st.h, st.conv, []
    for t in range(T):
        yt, h, tail = hymba._decode_ssm(lp, x[:, t:t + 1], h, tail, cfg)
        ys.append(yt)
    _close(torch.cat(ys, 1), y)
    _close(h, st_T.h)
    _close(tail, st_T.conv)


# ---------------------------------------------------------------------------
# the vlm's cross path and whisper's encoder
# ---------------------------------------------------------------------------


def test_vlm_cross_path_matches_reference(models):
    cfg, jcfg, jp, tp = models["llama-3.2-vision-11b"]
    img = _normal((2, cfg.image_tokens, cfg.d_model), 20)
    x = _normal((2, 5, cfg.d_model), 21)
    ck, cv = vlm.build_cross_kv(tp, torch.from_numpy(img), cfg)
    jck, jcv = jV.build_cross_kv(jp, jnp.asarray(img), jcfg)
    _close(ck, jck)
    _close(cv, jcv)
    for g, gate in enumerate(VLM_GATES):
        cp = tp.groups.cross[g]
        assert float(cp.gate_attn) == pytest.approx(gate)
        got = vlm.cross_apply(cp, torch.from_numpy(x), (ck[g], cv[g]), cfg)
        want = jV.cross_apply(jax.tree.map(lambda a: a[g],
                                           jp["groups"]["cross"]),
                              jnp.asarray(x), (jck[g], jcv[g]), jcfg, RULES)
        _close(got, want)
        assert float((got - torch.from_numpy(x)).abs().max()) > 1e-2


@pytest.mark.parametrize("use_flash", [False, True])
def test_whisper_encode_matches_reference(models, use_flash):
    """On the CPU the flash branch runs B5's plain version, non-causal."""
    cfg, jcfg, jp, tp = models["whisper-tiny"]
    frames = _normal((2, cfg.n_frames, cfg.d_model), 22)
    _close(whisper.encode(tp, torch.from_numpy(frames), cfg,
                          use_flash=use_flash),
           jW.encode(jp, jnp.asarray(frames), jcfg, RULES, remat=False))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _forward_pair(cfg, jcfg, jp, tp, toks, extra, **kw):
    mod, jmod = registry.model_module(cfg), jregistry.model_module(jcfg)
    args = (torch.from_numpy(toks),) + (
        () if extra is None else (torch.from_numpy(extra),))
    jargs = (jnp.asarray(toks),) + (
        () if extra is None else (jnp.asarray(extra),))
    got = mod.forward(tp, *args, cfg, **kw)
    want = jax.jit(lambda p, *a: jmod.forward(p, *a, jcfg, RULES,
                                             remat=False))(jp, *jargs)
    if cfg.family == "moe":           # (logits, aux)
        _close(got[1], want[1])
        got, want = got[0], want[0]
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    cfg, jcfg, jp, tp = models[arch]
    toks = _tokens(cfg, 2, 12)
    for use_flash in (False, True):
        got, want = _forward_pair(cfg, jcfg, jp, tp, toks, _extra(cfg, 2),
                                  use_flash=use_flash)
        assert got.shape == want.shape
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_fn_matches_reference(models, arch):
    cfg, jcfg, jp, tp = models[arch]
    toks = _tokens(cfg, 2, 9, seed=6)
    batch = {"tokens": torch.from_numpy(toks)}
    jbatch = {"tokens": jnp.asarray(toks)}
    extra = _extra(cfg, 2)
    if extra is not None:
        key = "image_embeds" if cfg.family == "vlm" else "frames"
        batch[key], jbatch[key] = torch.from_numpy(extra), jnp.asarray(extra)
    got = registry.make_prefill_fn(cfg, 16)(tp, batch)
    want = jregistry.make_prefill_fn(jcfg, RULES)(jp, jbatch)
    if cfg.family == "moe":           # (logits, cache)
        (got, cache), (want, jcache) = got, want
        assert cache.capacity == 16 and jcache.capacity == 9
        _close(cache.k[:, :, :9], jcache.k, 1e-4)
    _close(got, want, 1e-4)


def _caches(arch, cfg, jcfg, jp, tp, B, extra):
    """The decode state a family's serving starts from, in both packages,
    with the vlm's image and the audio family's frames given."""
    if cfg.family == "moe":
        return (kv_cache.make_cache(cfg, cfg.n_layers, B, 16, CPU),
                jkv.make_cache(jcfg, jcfg.n_layers, B, 16))
    if cfg.family == "hybrid":
        return hymba.make_cache(cfg, B, CPU), jH.make_cache(jcfg, B)
    if cfg.family == "vlm":
        cache = vlm.make_cache(cfg, B, 16, CPU)._replace(
            **dict(zip(("ck", "cv"), vlm.build_cross_kv(
                tp, torch.from_numpy(extra), cfg))))
        jcache = jV.make_cache(jcfg, B, 16)._replace(
            **dict(zip(("ck", "cv"), jV.build_cross_kv(
                jp, jnp.asarray(extra), jcfg))))
        return cache, jcache
    enc = whisper.encode(tp, torch.from_numpy(extra), cfg)
    jenc = jW.encode(jp, jnp.asarray(extra), jcfg, RULES, remat=False)
    cache = whisper.make_cache(cfg, B, 16, CPU)
    jcache = jW.make_cache(jcfg, B, 16)
    return (cache._replace(**dict(zip(("ck", "cv"), whisper.build_cross_kv(
                tp, enc, cfg)))),
            jcache._replace(**dict(zip(("ck", "cv"), jW.build_cross_kv(
                jp, jenc, jcfg)))))


def _tensors(cache):
    """A cache's arrays in order (the nested KV cache first), pos left
    out."""
    out = []
    for x in cache:
        if isinstance(x, tuple):
            out += _tensors(x)
        elif x is not None and not isinstance(x, int) and x.ndim:
            out.append(x)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(models, arch):
    """21 steps: hymba's ring of 16 slots wraps, the others' KV capacity
    of 16 wraps too; each step's logits and the caches at the end."""
    cfg, jcfg, jp, tp = models[arch]
    toks = _tokens(cfg, 2, 21, seed=3)
    cache, jcache = _caches(arch, cfg, jcfg, jp, tp, 2, _extra(cfg, 2))
    step = registry.make_decode_fn(cfg)
    jstep = jax.jit(jregistry.make_decode_fn(jcfg, RULES))
    for t in range(toks.shape[1]):
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]))
        got, cache = step(tp, cache, torch.from_numpy(toks[:, t]))
        _close(got, want, 1e-4)
    mine, theirs = _tensors(cache), _tensors(jcache)
    assert len(mine) == len(theirs)
    for g, w in zip(mine, theirs):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# the Server and the launcher
# ---------------------------------------------------------------------------


def _recording(decode, logs):
    def step(params, cache, token):
        lg, cache = decode(params, cache, token)
        logs.append(_np(lg))
        return lg, cache
    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_generates_the_reference_tokens(models, arch):
    """Two batches of 4 prompts of 2-24 tokens, 6 new tokens, capacity 32:
    the same tokens, and every decode step's logits (the prefix's steps
    and the generated ones) within 1e-4 of the reference ``Server``'s."""
    cfg, jcfg, jp, tp = models[arch]
    scfg = dict(max_new_tokens=6, capacity=32)
    jsrv = jserve.Server(jcfg, jp, jserve.ServeConfig(**scfg))
    srv = serve.Server(cfg, tp, serve.ServeConfig(**scfg), device=CPU)
    logs, jlogs = [], []
    srv._decode = _recording(srv._decode, logs)
    jsrv._decode = _recording(jsrv._decode, jlogs)
    rng = np.random.default_rng(0)
    for _ in range(2):
        prompts = [rng.integers(0, cfg.vocab, rng.integers(2, 25)).astype(
            np.int32) for _ in range(4)]
        want = jsrv.serve_batch([jsrv.admit(p) for p in prompts])
        got = srv.serve_batch([srv.admit(p) for p in prompts])
        assert [r.generated for r in got] == [r.generated for r in want]
        assert srv.timings[-1].prefix == max(map(len, prompts)) - 1
    assert len(logs) == len(jlogs) == sum(
        t.prefix + t.steps for t in srv.timings)
    err = max(float(np.abs(a - b).max()) for a, b in zip(logs, jlogs))
    assert err <= 1e-4, err
    assert srv.report() == jsrv.report()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(arch, capsys):
    out = launch.run(["--arch", arch, "--reduced", "--device", CPU,
                      "--requests", "3", "--batch", "2", "--new-tokens", "3",
                      "--prompt-len", "6"])
    text = capsys.readouterr().out
    assert "tok/s on cpu" in text and "parameters" in text
    assert out["served"] == 3 and not out["shed"]
    cfg = out["server"].model_cfg
    assert all(len(r.generated) == 3 and
               all(0 <= t < cfg.vocab for t in r.generated)
               for r in out["requests"])


def test_server_encodes_through_the_flash_entry(monkeypatch):
    """The audio Server encodes its zero frames through ``ops``' flash
    entry, non-causal, once an encoder layer a batch; the other three
    families' servers do not call it."""
    calls = []
    plain = ref.flash_attention_plain

    def flash(q, k, v, causal=True):
        calls.append(causal)
        return plain(q, k, v, causal=causal)
    monkeypatch.setattr(ref, "flash_attention_plain", flash)
    for arch in ARCHS:
        cfg = registry.get_config(arch).reduced()
        srv = serve.Server(cfg, registry.init_params(cfg, device=CPU),
                           serve.ServeConfig(max_new_tokens=2, capacity=16),
                           device=CPU)
        srv.serve_batch([srv.admit(np.arange(1, 6, dtype=np.int32))])
    assert calls == [False] * registry.get_config(
        "whisper-tiny").reduced().enc_layers
