"""Kernel B6's plain version (``repro_torch.kernels.ref.rwkv6_scan_plain``,
what ``ops.rwkv6_scan`` runs on the CPU) and the port's RWKV-6 model
(``repro_torch.models.rwkv6``) against the JAX package, on the CPU.

* the plain scan against ``repro.kernels.ref.rwkv6_scan_ref`` (the
  per-token oracle) and the interpret-mode Pallas ``rwkv6_scan_kernel``,
  on ``tests/test_kernels.py``'s ``RWKV_CASES``, a nonzero initial state
  and a ragged T; ``w`` below 1e-9 against the TPU kernel's clamp;
* ``wkv_chunked``, ``time_mix_apply``, ``forward`` (with the kernel's
  plain version and without) and ``decode_step`` of reduced ``rwkv6-3b``
  against the reference's, on the same weights
  (``convert.params_from_numpy``).

Inputs are seeded numpy draws given to both packages. Tolerances: the
scan's are the reference test's (f32 ``rtol=1e-3, atol=5e-4`` on the
output and 2e-4 on the state, 2e-2 / 5e-2 in bfloat16); the model's are
stated at each test (float32 end to end, only the summation order
differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan_kernel  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

RULES = Rules.disabled()
CPU = "cpu"

# (B, T, H, hd, chunk, dtype): the reference's sweep, then ragged T
RWKV_CASES = [
    (1, 16, 1, 8, 4, "float32"),
    (2, 32, 2, 16, 8, "float32"),
    (2, 64, 4, 32, 16, "float32"),
    (1, 64, 2, 64, 64, "float32"),
    (1, 32, 2, 16, 8, "bfloat16"),
    (2, 13, 2, 8, 13, "float32"),
    (1, 13, 2, 16, 13, "bfloat16"),
]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


def _scan_inputs(B, T, H, hd, dtype, seed=0, s0_scale=0.0):
    """Seeded (r, k, v, w, u, s0) as the reference test draws them, as
    (jax arrays, torch tensors); r/k/v in ``dtype``, the rest float32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    sig = 1 / (1 + np.exp(-n(B, T, H, hd)))
    jd = getattr(jnp, dtype)
    j = [jnp.asarray(n(B, T, H, hd)).astype(jd) for _ in range(3)]
    j += [jnp.asarray(sig * 0.5 + 0.4).astype(jd if dtype == "bfloat16"
                                              else jnp.float32),
          jnp.asarray(n(H, hd) * 0.1), jnp.asarray(n(B, H, hd, hd) * s0_scale)]
    td = getattr(torch, dtype)
    t = [_t(x, td) for x in j[:3]] + [_t(x) for x in j[3:]]
    return j, t


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(jnp.asarray(want).astype(
                                   jnp.float32)), **tol)


@pytest.mark.parametrize("B,T,H,hd,chunk,dtype", RWKV_CASES)
def test_plain_matches_oracle_and_pallas_kernel(B, T, H, hd, chunk, dtype):
    j, t = _scan_inputs(B, T, H, hd, dtype)
    out, s_T = ref.rwkv6_scan_plain(*t)
    assert out.dtype == t[0].dtype and s_T.dtype == torch.float32
    bf = dtype == "bfloat16"
    tol = dict(rtol=2e-2, atol=2e-2) if bf else dict(rtol=1e-3, atol=5e-4)
    stol = dict(rtol=5e-2, atol=5e-2) if bf else dict(rtol=2e-4, atol=2e-4)
    for want, want_s in (jref.rwkv6_scan_ref(*j),
                         rwkv6_scan_kernel(*j, chunk=chunk, interpret=True)):
        _close(out, want, **tol)
        _close(s_T, want_s, **stol)


def test_plain_with_nonzero_initial_state():
    j, t = _scan_inputs(1, 16, 2, 8, "float32", seed=3, s0_scale=0.2)
    out, s_T = ref.rwkv6_scan_plain(*t)
    want, want_s = rwkv6_scan_kernel(*j, chunk=4, interpret=True)
    _close(out, want, rtol=2e-5, atol=2e-5)
    _close(s_T, want_s, rtol=2e-5, atol=2e-5)
    assert torch.equal(ops.rwkv6_scan(*t)[0], out)   # ops on the CPU: plain


def test_plain_clamps_w_as_the_tpu_kernel_does():
    j, t = _scan_inputs(1, 8, 1, 8, "float32", seed=4, s0_scale=0.2)
    j[3] = j[3].at[:, 2:5].set(0.0)
    t[3][:, 2:5] = 0.0
    out, s_T = ref.rwkv6_scan_plain(*t)
    want, want_s = rwkv6_scan_kernel(*j, chunk=8, interpret=True)
    _close(out, want, rtol=1e-4, atol=1e-5)
    _close(s_T, want_s, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,chunk", [(1, 1), (16, 4), (13, 8)])
def test_wkv_chunked_matches_reference(T, chunk):
    j, t = _scan_inputs(2, T, 2, 8, "float32", seed=5, s0_scale=0.2)
    out, s = rwkv6.wkv_chunked(*t, chunk=chunk)
    want, want_s = jrwkv.wkv_chunked(*j, chunk=chunk)
    _close(out, want, rtol=1e-4, atol=1e-5)
    _close(s, want_s, rtol=1e-4, atol=1e-5)


CFG = registry.get_config("rwkv6-3b").reduced()
JCFG = jregistry.get_config("rwkv6-3b").reduced()


@pytest.fixture(scope="module")
def models():
    jp = jregistry.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.device_get(jp), CFG, CPU)


def _tokens(B, T, seed=1):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (B, T))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_time_mix_apply_matches_reference(models, use_kernel):
    jp, tp = models
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 11, CFG.d_model)).astype(np.float32)
    H, hd = rwkv6._heads(CFG)
    s = (rng.normal(0, 1, (2, H, hd, hd)) * 0.1).astype(np.float32)
    prev = rng.normal(0, 1, (2, CFG.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    want = jrwkv.time_mix_apply(jlp["rwkv"], jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(prev), JCFG, RULES)
    got = rwkv6.time_mix_apply(tp.layers[0].rwkv, torch.from_numpy(x),
                               torch.from_numpy(s), torch.from_numpy(prev),
                               CFG, use_kernel=use_kernel)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(models, use_kernel):
    jp, tp = models
    toks = _tokens(2, 12)
    want, wst = jrwkv.forward(jp, jnp.asarray(toks), JCFG, RULES, remat=False)
    got, st = rwkv6.forward(tp, torch.from_numpy(toks), CFG,
                            use_kernel=use_kernel)
    _close(got, want, rtol=1e-4, atol=1e-4)
    for g, w in zip(st, wst):
        _close(g, w, rtol=1e-4, atol=1e-4)
    last, _ = rwkv6.forward(tp, torch.from_numpy(toks), CFG,
                            use_kernel=use_kernel, last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_decode_step_matches_reference(models):
    jp, tp = models
    toks = _tokens(2, 10, seed=2)
    jst = jrwkv.stacked_state(JCFG, 2)
    st = rwkv6.stacked_state(CFG, 2, CPU)
    for t in range(toks.shape[1]):
        want, jst = jrwkv.decode_step(jp, jst, jnp.asarray(toks[:, t]), JCFG,
                                      RULES)
        got, st = rwkv6.decode_step(tp, st, torch.from_numpy(toks[:, t]),
                                    CFG)
        _close(got, want, rtol=1e-4, atol=1e-4)
    for g, w in zip(st, jst):
        _close(g, w, rtol=1e-4, atol=1e-4)


def test_prefill_through_the_scan_then_decode_matches_token_at_a_time(models):
    _, tp = models
    toks = torch.from_numpy(_tokens(3, 9, seed=3))
    _, st = rwkv6.forward(tp, toks[:, :8], CFG, use_kernel=True,
                          last_only=True)
    got, _ = rwkv6.decode_step(tp, st, toks[:, 8], CFG)
    st = rwkv6.stacked_state(CFG, 3, CPU)
    for t in range(9):
        want, st = rwkv6.decode_step(tp, st, toks[:, t], CFG)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stacked_state_layers_do_not_alias():
    st = rwkv6.stacked_state(CFG, 2, CPU)
    for x in st:
        assert x.shape[0] == CFG.n_layers
        x[0].add_(1.0)
        assert float(x[1].abs().sum()) == 0.0


def _decayed_inputs(T, decay, seed, B=2, H=2, hd=16):
    """``_scan_inputs`` with w replaced: at the clamp (1e-12 everywhere),
    mixing 1e-6 and 0.999, or the serving path's exp(-exp(-4))."""
    j, t = _scan_inputs(B, T, H, hd, "float32", seed=seed, s0_scale=0.2)
    rng = np.random.default_rng(seed + 1)
    w = {"clamp": np.full((B, T, H, hd), 1e-12),
         "mixed": np.where(rng.random((B, T, H, hd)) < 0.5, 1e-6, 0.999),
         "serving": np.full((B, T, H, hd), np.exp(-np.exp(-4.0)))}[decay]
    w = w.astype(np.float32)
    j[3], t[3] = jnp.asarray(w), torch.from_numpy(w)
    return j, t


@pytest.mark.parametrize("decay", ["clamp", "mixed"])
def test_wkv_chunked_at_chunk_16_with_w_at_the_clamp(decay):
    """``wkv_chunked`` at the kernel's chunk (16), its decays masked inside
    the exponent, where the factored form would overflow float32 (16
    tokens at the clamp: cum = -331): finite, and equal to the JAX oracle
    and the interpret-mode Pallas kernel within the reference's scan
    tolerances (mixed decays sum terms of very different sizes)."""
    j, t = _decayed_inputs(32, decay, seed=7)
    out, s = rwkv6.wkv_chunked(*t, chunk=16)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s).all())
    for want, want_s in (jref.rwkv6_scan_ref(*j),
                         rwkv6_scan_kernel(*j, chunk=16, interpret=True)):
        _close(out, want, rtol=1e-3, atol=5e-4)
        _close(s, want_s, rtol=2e-4, atol=2e-4)


def _chunk_mirror(r, k, v, w, u, s0, C=16):
    """B6's chunked form as ``csrc/rwkv6_scan.cu`` computes it, in float32
    torch: chunks of C tokens (the last padded with r = k = v = 0, w = 1);
    a chunk whose cumulative decay products all lie in [1e-30, 1e30] takes
    the factored form (products and one reciprocal), any other the form
    masked inside the exponent (logs, an exp a term); the bonus on the
    diagonal of the scores."""
    B, T, H, hd = r.shape
    f = lambda x: x.float().permute(0, 2, 1, 3)          # [B, H, T, hd]
    r, k, v, w = f(r), f(k), f(v), torch.clamp_min(f(w), 1e-9)
    pad = (-T) % C
    if pad:
        z = lambda x, val: torch.cat(
            [x, torch.full((B, H, pad, hd), val)], 2)
        r, k, v, w = z(r, 0.0), z(k, 0.0), z(v, 0.0), z(w, 1.0)
    s = s0.float().clone()
    outs = []
    below = torch.ones(C, C, dtype=torch.bool).tril(-1)
    for t0 in range(0, T + pad, C):
        R, K, V, W = (x[:, :, t0:t0 + C] for x in (r, k, v, w))
        P = torch.cumprod(W, 2)
        if bool(((P >= 1e-30) & (P <= 1e30)).all()):
            Pm = torch.cat([torch.ones_like(P[:, :, :1]), P[:, :, :-1]], 2)
            RD, KF = R * Pm, K / P
            KD, dec = K * (P[:, :, -1:] / P), P[:, :, -1]
            A = torch.einsum("bhik,bhjk->bhij", RD, KF)
        else:
            L = torch.cumsum(torch.log(W), 2)
            Lx = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], 2)
            RD, KD = R * torch.exp(Lx), K * torch.exp(L[:, :, -1:] - L)
            dec = torch.exp(L[:, :, -1])
            expo = Lx[:, :, :, None] - L[:, :, None]       # [B, H, i, j, hd]
            expo = torch.where(below[..., None], expo, float("-inf"))
            A = torch.einsum("bhik,bhjk,bhijk->bhij", R, K, torch.exp(expo))
        A = A * below + torch.diag_embed(torch.einsum(
            "bhik,hk,bhik->bhi", R, u.float(), K))
        outs.append(torch.einsum("bhik,bhkv->bhiv", RD, s)
                    + torch.einsum("bhij,bhjv->bhiv", A, V))
        s = dec[..., None] * s + torch.einsum("bhjk,bhjv->bhkv", KD, V)
    out = torch.cat(outs, 2)[:, :, :T].permute(0, 2, 1, 3)
    return out, s


@pytest.mark.parametrize("T,decay", [(15, "serving"), (16, "serving"),
                                     (17, "serving"), (37, "clamp"),
                                     (37, "mixed")])
def test_kernel_chunked_form_matches_oracle(T, decay):
    """The chunked form kernel B6 computes, both of its branches, against
    the JAX oracle: T = C - 1, C, C + 1 around its chunk, and decays that
    force the masked branch; finite throughout."""
    j, t = _decayed_inputs(T, decay, seed=8)
    out, s = _chunk_mirror(*t)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s).all())
    want, want_s = jref.rwkv6_scan_ref(*j)
    _close(out, want, rtol=1e-3, atol=5e-4)
    _close(s, want_s, rtol=2e-4, atol=2e-4)
    plain, plain_s = ref.rwkv6_scan_plain(*t)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-3,
                               atol=5e-4)
    np.testing.assert_allclose(s.numpy(), plain_s.numpy(), rtol=2e-4,
                               atol=2e-4)
