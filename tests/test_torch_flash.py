"""Kernel B5's plain version (``repro_torch.kernels.ref.
flash_attention_plain``, what ``ops.flash_attention`` runs on the CPU)
against the JAX package, on the CPU.

* against ``repro.kernels.ref.flash_attention_ref`` (the oracle) and the
  interpret-mode Pallas ``flash_attention_kernel`` with the reference
  test's block sizes, on ``tests/test_kernels.py``'s ``ATTN_CASES`` and on
  ragged S = 13 and 37 (blocks of S: the TPU kernel needs a divisor);
* ``models.layers.attend`` with ``use_flash`` against its naive branch.

Inputs are seeded numpy normals given to both packages. Tolerance: the
reference's own (``tests/test_kernels.py``): 2e-5 in float32, 2e-2 in
bfloat16; the two sum in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

# (B, S, H, KV, hd, dtype, causal, bq, bk): the reference's sweep, then
# ragged lengths with uneven groups
ATTN_CASES = [
    (1, 32, 2, 2, 16, "float32", True, 8, 8),
    (2, 64, 4, 2, 32, "float32", True, 16, 16),
    (2, 64, 4, 1, 32, "float32", False, 32, 16),
    (1, 128, 8, 2, 64, "float32", True, 64, 32),
    (1, 64, 4, 4, 64, "bfloat16", True, 16, 16),
    (2, 48, 6, 3, 16, "float32", True, 16, 16),
    (1, 128, 2, 2, 128, "float32", False, 128, 128),
    (2, 13, 6, 3, 16, "float32", True, 13, 13),
    (1, 37, 6, 3, 64, "float32", True, 37, 37),
    (2, 37, 15, 5, 64, "bfloat16", True, 37, 37),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _qkv(B, S, H, KV, hd, dtype, seed=0):
    """Seeded q, k, v as (jax arrays, torch tensors) of ``dtype``; bfloat16
    values are rounded once, in JAX, and handed over exactly."""
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1, (B, S, n, hd)).astype(np.float32)
           for n in (H, KV, KV)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in raw]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal,bq,bk", ATTN_CASES)
def test_plain_matches_oracle_and_pallas_kernel(B, S, H, KV, hd, dtype,
                                                causal, bq, bk):
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, KV, hd, dtype)
    got = ref.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    kern = flash_attention_kernel(jq, jk, jv, causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(kern), **_tol(dtype))


def test_ops_entry_runs_the_plain_version_on_the_cpu():
    _, (q, k, v) = _qkv(2, 29, 6, 2, 32, "float32", seed=1)
    for causal in (True, False):
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                           ref.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_attend_flash_branch_matches_naive(causal):
    _, (q, k, v) = _qkv(2, 21, 4, 2, 16, "float32", seed=2)
    pos = torch.arange(21)
    naive = layers.attend(q, k, v, pos, pos, causal=causal)
    flash = layers.attend(q, k, v, pos, pos, causal=causal, use_flash=True)
    np.testing.assert_allclose(_np(flash), _np(naive), rtol=2e-5, atol=2e-5)


def _tensor_core_mirror(q, k, v, causal, tile=64):
    """B5's tensor-core numerics in plain torch: bf16 q, k, v; the scores
    in float32, scaled there (times log2 e, through exp2); the online
    softmax over tiles of 64 keys from a running max of finfo(float32).min;
    P rounded to bf16 before the P V product, whose sums are float32; the
    denominator summed from the unrounded P; the row divided by
    max(l, 1e-30) and rounded to bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qh = q.float().reshape(B, S, KV, H // KV, hd)
    c = hd ** -0.5 * 1.4426950408889634
    m = torch.full((B, KV, H // KV, S), torch.finfo(torch.float32).min)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, KV, H // KV, S, hd)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kt = k[:, k0:k0 + tile].float()
        vt = v[:, k0:k0 + tile].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qh, kt) * c
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.bfloat16().float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).bfloat16()


# (B, S, H, KV, hd, causal): the serving path's problem (S = 467: a ragged
# last tile), then the tensor-core route's smaller edges
MIRROR_CASES = [(2, 467, 15, 5, 64, True),
                (2, 467, 15, 5, 64, False),
                (1, 65, 8, 1, 128, True),
                (2, 127, 6, 3, 32, False),
                (1, 127, 8, 8, 16, True)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal", MIRROR_CASES)
def test_tensor_core_rounding_matches_oracle_and_pallas_kernel(B, S, H, KV,
                                                                hd, causal):
    """A mirror of B5's bf16 route (scores scaled in float32, P rounded to
    bf16 before P V, float32 sums) sits within the bf16 tolerance of the
    JAX oracle and the interpret-mode Pallas kernel (one block: S has no
    smaller divisor the TPU kernel could use)."""
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, KV, hd, "bfloat16", seed=S + hd)
    got = _tensor_core_mirror(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    kern = flash_attention_kernel(jq, jk, jv, causal=causal, block_q=S,
                                  block_k=S, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))
    np.testing.assert_allclose(_np(got), _np(kern), **_tol("bfloat16"))
