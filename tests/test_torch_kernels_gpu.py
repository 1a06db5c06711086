"""The CUDA kernels of the port against their plain torch versions, on the
card. Every test here needs a CUDA device and skips without one; run them
on the GPU machine with

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance for the database kernels (B1-B4): exact. Every output is an
integer, a bool, a selection, a float32 product of two exact operands
(``price x qty``), or a float32 row sum that kernel and plain version both
take in line order, so they agree bit for bit. Payment's float
scatter-adds land in batch order on the card as on the CPU, so its state
agrees bit for bit too. For attention (B5) and the RWKV-6 scan (B6) the
kernels sum in another order than their plain versions: the reference's
tolerances (``tests/test_kernels.py``), 2e-5 in float32 and 2e-2 in
bfloat16 for attention; for the scan ``rtol=1e-3, atol=5e-4`` on the output
and 2e-4 on the state in float32, 2e-2 and 5e-2 in bfloat16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.escrow_admit import (  # noqa: E402
    contention_gate, escrow_admit_cuda, residual_fcfs, residual_order,
    walk_hash, walk_shape)
from repro_torch.kernels.ramp_read import (  # noqa: E402
    ramp_read_cuda, ramp_read_plain)
from repro_torch.kernels.txn_megastep import (  # noqa: E402
    MegastepOut, txn_megastep_cuda, txn_megastep_plain)
from repro_torch.txn import tpcc  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    logs = build.build_all()
    for name, log in logs.items():
        print(f"-- {name} --\n{log}")
    return torch.device("cuda")


BIG = np.iinfo(np.int32).max // 2
DENSE_CELLS = 64 * 100_000   # the dense escrow layout at 64 warehouses


def _problem(seed, B=16, L=6, A=48, n_keys=12, n_cells=40, lo=0, hi=40,
             dup_heavy=False, distinct=False, collide=0, by="hash",
             sentinel=False, dense=False, device="cpu"):
    """A seeded megastep problem. ``distinct``: all B x L slots distinct
    (A = B L) and every transaction residual (its first line valid and one
    short of its cell); ``collide``: the slots take ``collide`` values
    that share the walk table's first probe (``by="hash"``: equal under
    its hash, so one probe chain) or are equal modulo the table size
    (``by="mod"``: the runs of neighbours the hash must scatter);
    ``sentinel``: the last cell holds the BIG remote-cold sentinel and a
    fifth of the lines name it; ``dense``: the dense escrow layout's
    availability vector of 64 warehouses x 100,000 items, slots ``w *
    100,000 + i`` of warehouses 42-63 (every slot above 2**22), uniform
    items, and three lines of every other transaction on one of 16
    neighbouring items of warehouse 63."""
    rng = np.random.default_rng(seed)
    H = walk_shape(B, L)[1]
    if distinct:
        A = B * L
    if dense:
        A = DENSE_CELLS
    if collide:
        if by == "mod":
            values = 7 + H * np.arange(collide)
        else:
            cand = np.arange(1 << 22, dtype=np.int64)
            hashed = walk_hash(cand, H)
            values = cand[hashed == hashed[7]][:collide]
        A = int(values.max()) + 8
    cells = max(2, A // 4) if dup_heavy else A
    lv = rng.random((B, L)) < 0.85
    loc = (rng.random((B, L)) < 0.7) & lv
    avail0 = rng.integers(lo, hi + 1, A).astype(np.int32)
    slot = rng.integers(0, cells, (B, L)).astype(np.int32)
    qty = rng.integers(1, 11, (B, L)).astype(np.int32)
    if distinct:
        slot = rng.permutation(A).reshape(B, L).astype(np.int32)
        lv[:, 0] = True
        avail0[slot[:, 0]] = qty[:, 0] - 1
    if collide:
        slot = values[rng.integers(0, collide, (B, L))].astype(np.int32)
    if sentinel:
        avail0[-1] = BIG
        slot = np.where(rng.random((B, L)) < 0.2, A - 1, slot).astype(
            np.int32)
    if dense:
        w = rng.integers(42, 64, (B, L))
        item = rng.integers(0, 100_000, (B, L))
        w[::2, :3] = 63
        item[::2, :3] = rng.integers(0, 16, (B, L))[::2, :3]
        slot = (w * 100_000 + item).astype(np.int32)
    arrays = dict(
        avail0=avail0,
        slot=slot,
        qty=qty,
        line_valid=lv,
        key_local=rng.integers(0, n_keys, B).astype(np.int32),
        cell_local=np.where(loc, rng.integers(0, n_cells, (B, L)),
                            0).astype(np.int32),
        local_line=loc,
        remote_line=(rng.random((B, L)) < 0.3) & lv,
        ramp_ts=rng.integers(0, 1 << 20, B).astype(np.int32),
        price_row=rng.integers(1, 100, (B, L)).astype(np.float32))
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return t, dict(n_keys=n_keys, n_cells=n_cells)


CASES = [
    dict(hi=12),                                   # scarce: mostly residual
    dict(lo=300, hi=500),                          # plump: all fast, n_res 0
    dict(dup_heavy=True, hi=50),                   # duplicate cells
    dict(B=32, L=8, A=80, n_keys=6, n_cells=24, hi=60),
    dict(B=256, L=15, A=4096, n_keys=640, n_cells=4000, hi=30),
    # every transaction residual, all B x L slots distinct
    dict(B=256, L=15, n_keys=640, n_cells=4000, distinct=True, hi=12),
    # more than one walk tile, contended across the tile boundaries
    dict(B=1024, L=15, A=2048, n_keys=640, n_cells=4000, hi=30),
    # 12 slots of one first probe in the walk's hash table: one chain
    dict(B=64, L=8, n_keys=16, collide=12, hi=40),
    # 12 slots equal modulo the table size
    dict(B=64, L=8, n_keys=16, collide=12, by="mod", hi=40),
    # the BIG sentinel cell beside contended ones
    dict(B=128, L=15, A=600, n_keys=64, sentinel=True, hi=20),
    # the dense layout's 6.4 M cells: scarce, then plumper
    dict(B=256, L=15, n_keys=640, n_cells=4000, dense=True, hi=30),
    dict(B=256, L=15, n_keys=640, n_cells=4000, dense=True, lo=100, hi=150),
]
PLUMP, DISTINCT, TILES, DENSE = 1, 5, 6, (10, 11)


def _check_case(case, n_res, B, L, slot=None):
    """What each case is for actually happened."""
    n = int(n_res[0])
    if case in DENSE:
        assert 0 < n < B and int(slot.min()) >= 1 << 22
    if case == PLUMP:
        assert n == 0
    if case == DISTINCT:
        assert n == B
    if case == TILES:
        assert n > walk_shape(B, L)[0]


def _equal(a, b, tag):
    for name, x, y in zip(MegastepOut._fields, a, b):
        assert x.dtype == y.dtype, f"{tag}: {name} dtype"
        assert torch.equal(x.cpu(), y.cpu()), f"{tag}: {name}"


@pytest.mark.parametrize("case", range(len(CASES)))
def test_escrow_admit_kernel_matches_plain(cuda, case):
    t, _ = _problem(case, device=cuda, **CASES[case])
    args = (t["avail0"], t["slot"], t["qty"], t["line_valid"])
    fast, _, _ = contention_gate(*args)
    res_idx, n_res = residual_order(fast)
    _check_case(case, n_res, *args[1].shape, slot=args[1])
    before = escrow_admit_cuda.launches
    # the kernel updates its avail0 in place: give it a copy
    fresh = args[0].clone()
    got = escrow_admit_cuda(fresh, *args[1:], fast, res_idx, n_res)
    torch.cuda.synchronize()
    assert escrow_admit_cuda.launches == before + 1
    assert got[1].data_ptr() == fresh.data_ptr()
    want = residual_fcfs(*args, fast, res_idx, n_res)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    c_ops, a_ops = ops.escrow_admit(args[0].clone(), *args[1:])
    assert escrow_admit_cuda.launches == before + 2
    c_ref, a_ref = ref.escrow_admit_ref(*args)
    assert torch.equal(c_ops, c_ref) and torch.equal(a_ops, a_ref)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_txn_megastep_kernel_matches_plain(cuda, case):
    t, kw = _problem(100 + case, device=cuda, **CASES[case])
    args = tuple(t.values())
    avail0, slot, qty, lv = args[:4]
    fast, _, _ = contention_gate(avail0, slot, qty, lv)
    res_idx, n_res = residual_order(fast)
    _check_case(case, n_res, *slot.shape, slot=slot)
    gate = (fast, res_idx, n_res)
    before = txn_megastep_cuda.launches
    # the kernel updates its avail0 in place: give it a copy
    fresh = avail0.clone()
    got = txn_megastep_cuda(fresh, slot, qty, lv, *gate, *args[4:], **kw)
    torch.cuda.synchronize()
    assert txn_megastep_cuda.launches == before + 1
    assert got.avail.data_ptr() == fresh.data_ptr()
    plain = txn_megastep_plain(avail0, slot, qty, lv, *gate, *args[4:], **kw)
    _equal(got, plain, "kernel vs plain")
    _equal(ops.txn_megastep(avail0.clone(), *args[1:], **kw),
           MegastepOut(*ref.txn_megastep_ref(*args, **kw)), "ops vs oracle")
    assert txn_megastep_cuda.launches == before + 2


def _read_problem(seed, R, L, device, hide=0.5):
    """A seeded fused-read problem: half the rows' stamps match their
    commit record, ``hide`` of the lines are invisible (so the lookback
    repairs), and nlines runs over 0..L."""
    rng = np.random.default_rng(seed)
    req = rng.integers(-1, 1 << 20, R).astype(np.int32)
    ts = rng.integers(-1, 1 << 20, (R, L)).astype(np.int32)
    match_rows = rng.random(R) < 0.5
    ts[match_rows] = req[match_rows, None]
    nl = rng.integers(0, L + 1, R).astype(np.int32)
    nl[0], nl[-1] = 0, L
    prep = rng.random((R, L)) < 0.9
    vis = prep & (rng.random((R, L)) >= hide)
    arrays = (req, nl, ts, vis, prep,
              rng.uniform(0, 1e4, (R, L)).astype(np.float32),
              rng.integers(0, 100_000, (R, L)).astype(np.int32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("R,L", [(1, 15), (64, 15), (100, 15), (4097, 15),
                                 (300, 32), (77, 5)])
def test_ramp_read_kernel_matches_plain(cuda, R, L):
    """Row counts a 64-row block does not divide, nlines of 0 and L, and
    concealed lines that the lookback repairs."""
    args = _read_problem(R * 31 + L, R, L, cuda)
    before = ramp_read_cuda.launches
    got = ramp_read_cuda(*args)
    torch.cuda.synchronize()
    assert ramp_read_cuda.launches == before + 1
    want = ramp_read_plain(*args)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    for x, y in zip(ops.ramp_read_select(*args), ref.ramp_read_ref(*args)):
        assert torch.equal(x, y)
    if R >= 64:
        assert int(got[5].sum()) > 0      # the repair branch ran


def test_payment_on_the_card_matches_the_cpu(cuda):
    """Duplicate-heavy Payments (256 a batch into 2 x 2 x 8 customers) on
    the card equal the same Payments on the CPU bit for bit, and two runs
    on the card agree. Also prints whether torch's own ``index_put_``
    accumulate would have agreed (it need not: that is why Payment orders
    its adds itself)."""
    scale = tpcc.TPCCScale(n_warehouses=2, districts=2, customers=8,
                           n_items=64, order_capacity=32)
    rng = np.random.default_rng(21)
    batches = [tpcc.generate_payment(rng, scale, 256, device="cpu")
               for _ in range(4)]
    runs = []
    for dev in ("cpu", cuda, cuda):
        state = tpcc.init_state(scale, seed=2, device=dev)
        for b in batches:
            state = tpcc.apply_payment(state, type(b)(*(x.to(dev)
                                                        for x in b)))
        runs.append(tpcc.TPCCState(*(x.cpu() for x in state)))
    for name, a, b, c in zip(tpcc.TPCCState._fields, *runs):
        assert torch.equal(a, b), f"card != cpu: {name}"
        assert torch.equal(b, c), f"card run 1 != run 2: {name}"
    naive = {}
    for dev in ("cpu", cuda):
        w_ytd = torch.zeros(2, device=dev)
        for b in batches:
            w_ytd.index_put_((b.w.to(dev).long(),), b.amount.to(dev),
                             accumulate=True)
        naive[str(dev)] = w_ytd.cpu()
    print(f"index_put_ accumulate, card == cpu: "
          f"{torch.equal(naive['cpu'], naive['cuda'])}; batch order: "
          f"{torch.equal(naive['cpu'], runs[0].w_ytd)}")


def _bits(x):
    """``x`` as integers of its width, so NaN payloads compare bit for
    bit."""
    if x.is_floating_point():
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
    return x


def _merge_problem(seed, R, W, pay, ver, device, big=False):
    """A seeded B4 problem: tied and differing stamps (above 2**31 with
    ``big``), partial validity, payloads around the thresholds with NaNs
    and 0.1s in the float ones."""
    rng = np.random.default_rng(seed)
    base = 2**31 - 30 if big else -1
    va, vb = (rng.integers(base, base + 60, R) for _ in range(2))
    vb[: R // 4] = va[: R // 4]
    sides = []
    for v in (va, vb):
        p = rng.normal(0, 1, (R, W)).astype(np.float32)
        p[rng.random((R, W)) < 0.1] = 0.1
        if pay != "int32":
            p[rng.random((R, W)) < 0.05] = np.nan
        else:
            p = np.round(p * 2**24)
        sides.append((torch.from_numpy(rng.random(R) < 0.7),
                      torch.from_numpy(v).to(getattr(torch, ver)),
                      torch.from_numpy(p).to(getattr(torch, pay))))
    return tuple(x.to(device) for s in sides for x in s)


MERGE_EDGES = [(1, 4, "float32", "int64", False),
               (257, 4, "float32", "int64", True),
               (1000, 1, "float32", "int64", False),
               (300, 8, "bfloat16", "int64", True),
               (77, 3, "bfloat16", "int32", False),
               (300, 4, "float32", "int32", False),
               (129, 5, "int32", "int64", True),
               (4096, 4, "int32", "int32", False)]


@pytest.mark.parametrize("R,W,pay,ver,big", MERGE_EDGES)
def test_lattice_merge_kernel_matches_plain(cuda, R, W, pay, ver, big):
    """Kernel B4 against its plain version bit for bit, with ``hi=0.1``
    (which must flag no payload of 0.1 in its own dtype), through the
    wrapper, ``ops``, ``VersionedSlots.join`` and the fused merge."""
    from repro_torch.core import lattice, merge
    from repro_torch.kernels.lattice_merge import (lattice_merge_cuda,
                                                   lattice_merge_plain)

    args = _merge_problem(R * 7 + W, R, W, pay, ver, cuda, big)
    before = lattice_merge_cuda.launches
    got = lattice_merge_cuda(*args, lo=-1.0, hi=0.1)
    torch.cuda.synchronize()
    assert lattice_merge_cuda.launches == before + 1
    want = lattice_merge_plain(*args, lo=-1.0, hi=0.1)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))
    a, b = lattice.VersionedSlots(*args[:3]), lattice.VersionedSlots(*args[3:])
    fused, viol = merge.merge_versioned_fused(a, b, lo=-1.0, hi=0.1)
    joined = lattice.VersionedSlots.join(a, b)
    assert lattice_merge_cuda.launches == before + 3
    for x, y, z in zip(fused, joined, want):
        assert torch.equal(_bits(x), _bits(z)) and torch.equal(_bits(y),
                                                                _bits(z))
    assert torch.equal(viol, want[3])
    cpu = lattice_merge_plain(*(x.cpu() for x in args), lo=-1.0, hi=0.1)
    for x, y in zip(got, cpu):
        assert torch.equal(_bits(x.cpu()), _bits(y))


def test_lattice_merge_misaligned_payload_and_bad_types(cuda):
    """A payload view 4 bytes off 16-byte alignment takes the element path
    and agrees; a payload or stamp dtype the kernel lacks raises
    ``TypeError`` on the card instead of running the plain version."""
    from repro_torch.kernels.lattice_merge import (lattice_merge_cuda,
                                                   lattice_merge_plain)

    R, W = 999, 4
    args = list(_merge_problem(5, R, W, "float32", "int64", cuda))
    for i in (2, 5):
        buf = torch.empty(R * W + 1, dtype=torch.float32, device=cuda)
        buf[1:].copy_(args[i].view(-1))
        args[i] = buf[1:].view(R, W)
        assert args[i].data_ptr() % 16 != 0
    got = lattice_merge_cuda(*args, lo=-0.5, hi=0.5)
    for x, y in zip(got, lattice_merge_plain(*args, lo=-0.5, hi=0.5)):
        assert torch.equal(_bits(x), _bits(y))
    with pytest.raises(TypeError, match="payload"):
        lattice_merge_cuda(*args[:2], args[2].double(), *args[3:5],
                           args[5].double())
    with pytest.raises(TypeError, match="stamps"):
        lattice_merge_cuda(args[0], args[1].short(), *args[2:4],
                           args[4].short(), args[5])


# (B, S, H, KV, hd, dtype, causal): tiny, ragged (S = 13, 129, 509),
# groups 1, 3 and 8, every head dim, full and causal, both dtypes
FLASH_EDGES = [(1, 2, 2, 2, 16, "float32", True),
               (2, 13, 6, 2, 16, "float32", True),
               (2, 13, 6, 3, 32, "bfloat16", False),
               (1, 129, 8, 1, 128, "float32", True),
               (1, 129, 8, 1, 128, "bfloat16", False),
               (2, 64, 4, 4, 64, "float32", False),
               (3, 509, 15, 5, 64, "bfloat16", True),
               (1, 509, 15, 5, 64, "float32", True),
               # the tensor-core route: every head dim, S = 65 and 127 (a
               # ragged 64-row tile), causal and full, groups 1, 3 and 8
               (1, 65, 8, 8, 16, "bfloat16", True),
               (2, 65, 6, 2, 16, "bfloat16", False),
               (1, 127, 8, 1, 32, "bfloat16", True),
               (2, 65, 3, 1, 32, "bfloat16", False),
               (2, 127, 4, 4, 64, "bfloat16", True),
               (1, 65, 15, 5, 64, "bfloat16", False),
               (1, 127, 15, 5, 128, "bfloat16", True),
               (1, 65, 8, 1, 128, "bfloat16", False),
               (1, 127, 24, 8, 128, "bfloat16", True)]


def _attn_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,causal", FLASH_EDGES)
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, KV, hd, dtype,
                                              causal):
    """Kernel B5 against its plain version, through the wrapper and
    ``ops``; the launch takes its dtype's route (bfloat16: the tensor
    cores); a head dim or dtype the kernel lacks raises."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator(device=cuda).manual_seed(S * 31 + hd)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=cuda).to(dt)
               for n in (H, KV, KV))
    before = flash_attention_cuda.launches
    routes = dict(flash_attention_cuda.route_launches)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    route = "tensor_core" if dtype == "bfloat16" else "float32"
    routes[route] += 1
    assert flash_attention_cuda.route_launches == routes
    want = ref.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_attn_tol(dtype))
    cpu = ref.flash_attention_plain(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    torch.testing.assert_close(got.cpu().float(), cpu.float(),
                               **_attn_tol(dtype))
    with pytest.raises(ValueError, match="hd="):
        flash_attention_cuda(q[..., :8].contiguous(), k[..., :8].contiguous(),
                             v[..., :8].contiguous())
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half())


# (B, T, H, hd, dtype, s0 scale): T = 2, 13, 64, 509; every head dim
RWKV_EDGES = [(2, 2, 3, 8, "float32", 0.0),
              (2, 13, 8, 8, "float32", 0.2),
              (1, 64, 4, 16, "bfloat16", 0.2),
              (2, 64, 2, 32, "float32", 0.2),
              (1, 509, 4, 64, "float32", 0.0),
              (2, 509, 40, 64, "bfloat16", 0.2),
              (1, 40, 2, 128, "float32", 0.2)]


@pytest.mark.parametrize("B,T,H,hd,dtype,s0_scale", RWKV_EDGES)
def test_rwkv6_scan_kernel_matches_plain(cuda, B, T, H, hd, dtype, s0_scale):
    """Kernel B6 against its plain version, through the wrapper and
    ``ops``, with decays as the reference's sweep draws them."""
    _check_rwkv6_scan(cuda, B, T, H, hd, dtype, s0_scale, "sigmoid")


# (B, T, H, hd, dtype, decay) for the chunked form (chunk C = 16): w at the
# clamp (1e-12 everywhere, cumulative decays far below float32's range), w
# mixing 1e-6 and 0.999, the serving path's w = exp(-exp(-4)), and T = C - 1,
# C, C + 1; s0 nonzero throughout
RWKV_DECAY_EDGES = [(2, 64, 4, 64, "float32", "clamp"),
                    (1, 40, 2, 64, "bfloat16", "clamp"),
                    (1, 17, 2, 8, "float32", "clamp"),
                    (2, 64, 4, 64, "float32", "mixed"),
                    (1, 509, 8, 64, "bfloat16", "mixed"),
                    (1, 33, 2, 16, "float32", "mixed"),
                    (2, 15, 3, 64, "float32", "sigmoid"),
                    (2, 16, 3, 32, "float32", "sigmoid"),
                    (2, 17, 3, 128, "bfloat16", "sigmoid"),
                    (1, 17, 4, 64, "float32", "serving")]


@pytest.mark.parametrize("B,T,H,hd,dtype,decay", RWKV_DECAY_EDGES)
def test_rwkv6_scan_kernel_decay_edges(cuda, B, T, H, hd, dtype, decay):
    """Kernel B6 against its plain version where the chunked form's
    cumulative decays leave float32's range (the masked form) and where
    they do not, and around the chunk's length; outputs finite."""
    _check_rwkv6_scan(cuda, B, T, H, hd, dtype, 0.2, decay)


def _check_rwkv6_scan(cuda, B, T, H, hd, dtype, s0_scale, decay):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda

    gen = torch.Generator(device=cuda).manual_seed(T * 17 + hd)
    n = lambda *s: torch.randn(s, generator=gen, device=cuda)
    dt = getattr(torch, dtype)
    r, k, v = (n(B, T, H, hd).to(dt) for _ in range(3))
    shape = (B, T, H, hd)
    w = {"sigmoid": lambda: torch.sigmoid(n(*shape)) * 0.5 + 0.4,
         "clamp": lambda: torch.full(shape, 1e-12, device=cuda),
         "mixed": lambda: torch.where(n(*shape) > 0, 1e-6, 0.999),
         "serving": lambda: torch.full(shape, float(np.exp(-np.exp(-4.0))),
                                       device=cuda)}[decay]()
    u = n(H, hd) * 0.1
    s0 = n(B, H, hd, hd) * s0_scale
    before = rwkv6_scan_cuda.launches
    out, s_T = ops.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 1
    want, want_s = ref.rwkv6_scan_plain(r, k, v, w, u, s0)
    bf = dtype == "bfloat16"
    assert out.dtype == want.dtype and s_T.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all()) and \
        bool(torch.isfinite(s_T).all())
    torch.testing.assert_close(
        out.float(), want.float(),
        **(dict(rtol=2e-2, atol=2e-2) if bf else dict(rtol=1e-3, atol=5e-4)))
    torch.testing.assert_close(
        s_T, want_s,
        **(dict(rtol=5e-2, atol=5e-2) if bf else dict(rtol=2e-4, atol=2e-4)))


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_four_replicas_through_each_kernel_match_the_plain_path(cuda, layout):
    """Escrow with R = 4 replicas on one card (``Engine(n_shards=4)``):
    through the megastep (B2) and through escrow_admit (B1), a launch a
    shard a batch, bit-equal to each other, to the plain path on the card
    and to the plain path on the CPU, and audited."""
    from repro_torch.txn import run_loop
    from repro_torch.txn.engine import Engine

    scale = tpcc.TPCCScale(n_warehouses=8, districts=4, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    kw = dict(batch_per_shard=16, n_batches=6, remote_frac=0.3,
              merge_every=2, refresh_every=1, seed=5, item_skew=1.2)
    runs = {}
    for dev, admission, effects in (("cpu", "scan", "scan"),
                                    (cuda, "scan", "scan"),
                                    (cuda, "kernel", "fused"),
                                    (cuda, "kernel", "scan")):
        e = Engine(scale, stock_invariant="strict", escrow_layout=layout,
                   hot_items=4, admission=admission, effects=effects,
                   device=dev, n_shards=4)
        state = tpcc.init_state(scale, device=dev)
        state.s_quantity.mul_(3)
        escrow_admit_cuda.launches = txn_megastep_cuda.launches = 0
        s, esc, st = run_loop(e, state, audit=True, **kw)
        runs[(str(dev), admission, effects)] = (
            [x.cpu() for x in (*s, *esc)],
            (st.neworders, st.aborts, st.cold_rejects, st.refreshes),
            (escrow_admit_cuda.launches, txn_megastep_cuda.launches))
    want, counts, _ = runs[("cpu", "scan", "scan")]
    assert counts[0] > 0 and counts[1] > 0
    per_run = 4 * (kw["n_batches"] + 1)    # a shard a batch, and the warm-up
    expect = {("scan", "scan"): (0, 0), ("kernel", "fused"): (0, per_run),
              ("kernel", "scan"): (per_run, 0)}
    for key, (got, c, launches) in runs.items():
        assert all(torch.equal(x, y) for x, y in zip(got, want)), key
        assert c == counts, key
        assert launches == expect[key[1:]], (key, launches)


def test_cold_retry_ring_on_the_card_matches_the_cpu(cuda):
    """The cold-retry ring with reservations at R = 4 (the reference's
    reclaim-test scale and knobs): through the megastep (B2) on the card
    and through the plain path on the CPU, the same state, escrow, ring
    and counts, with a reservation granted."""
    from repro_torch.txn import run_loop
    from repro_torch.txn.engine import Engine

    scale = tpcc.TPCCScale(n_warehouses=4, districts=2, customers=8,
                           n_items=32, order_capacity=512, max_lines=15)
    kw = dict(batch_per_shard=8, n_batches=16, remote_frac=0.6,
              merge_every=4, refresh_every=1, seed=3, item_skew=1.5,
              retry_cap=256, retry_max=3, retry_reserve=1,
              final_flush=False, return_retry=True, audit=True)
    runs = []
    for dev, admission, effects in (("cpu", "scan", "scan"),
                                    (cuda, "kernel", "fused")):
        e = Engine(scale, stock_invariant="strict", admission=admission,
                   effects=effects, device=dev, n_shards=4)
        txn_megastep_cuda.launches = 0
        s, esc, st, ring = run_loop(e, tpcc.init_state(scale, device=dev),
                                    **kw)
        runs.append(([x.cpu() for x in (*s, *esc, *ring)],
                     (st.neworders, st.aborts, st.cold_rejects,
                      st.refreshes), txn_megastep_cuda.launches,
                     int(ring.reserved.sum())))
    (want, counts, _, reserved), (got, c, launches, _) = runs
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert c == counts and counts[2] > 0 and reserved > 0
    assert launches == 4 * (kw["n_batches"] + 1)


@pytest.fixture(scope="module")
def card():
    """The card alone: the stock scatter is torch ops, no kernel to
    build."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scatter's atomics run only on "
                    "the card")
    return torch.device("cuda")


def _stock_scale(W=256):
    """The spec's stock tables (``W`` x 100,000 items) with the other
    tables cut to nothing: the drains read and write the stock alone."""
    return tpcc.TPCCScale(n_warehouses=W, districts=1, customers=2,
                          n_items=100_000, order_capacity=2, max_lines=15)


def _stock_state(scale, seed, device):
    state = tpcc.init_state(scale, seed=seed, device=device)
    state.s_ytd.copy_(state.s_quantity.to(state.s_ytd.dtype) * 3)
    return state


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("drain", ["merge", "strict"])
def test_spec_ring_drain_on_the_card_matches_the_cpu(card, drain, R):
    """A drain of a spec-shaped ring (8 rows x 256 New-Orders x 15 lines,
    30,720 lanes, 1% live, half of those on 16 cells so live lanes
    collide on cold cells) through the engine's drain bodies: the stock columns and the
    cold rejects on the card equal the CPU's bit for bit, ``s_ytd``
    included (its adds are integers, exact in any order)."""
    from repro_torch.txn import engine as eg

    scale = _stock_scale()
    W, I, N = scale.n_warehouses, scale.n_items, 8 * 256 * 15
    rng = np.random.default_rng(40 + R)
    live = rng.random(N) < 0.01
    hot = rng.random(N) < 0.5
    dst_w = np.where(hot, 3, rng.integers(0, W, N)).astype(np.int32)
    i_id = np.where(hot, 5000 + rng.integers(0, 16, N),
                    rng.integers(0, I, N)).astype(np.int32)
    cols = (dst_w, i_id, rng.integers(1, 11, N).astype(np.int32), live)
    keys = torch.from_numpy(tpcc.select_hot_cells(scale, 1000))
    out = []
    for dev in ("cpu", card):
        state = _stock_state(scale, 9, dev)
        outbox = tpcc.StockDelta(*(torch.from_numpy(x).to(dev)
                                   for x in cols))
        if drain == "merge":
            eg.gather_and_apply_outbox(state, outbox, W // R, R)
            rej = torch.zeros(R, dtype=torch.int32)
        else:
            state, rej = eg.gather_and_apply_outbox_strict(
                state, outbox, keys.to(dev), W // R, I, R)
        out.append([x.cpu() for x in (state.s_quantity, state.s_ytd,
                                      state.s_order_cnt, state.s_remote_cnt,
                                      rej)])
    want, got = out
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.is_floating_point() else x,
            y.view(torch.int32) if y.is_floating_point() else y)
    assert int(want[2].sum()) > int(_stock_state(
        scale, 9, "cpu").s_order_cnt.sum())
    if drain == "strict":
        assert int(want[-1].sum()) > 0   # a cold cell did not fit


def test_captured_neworder_stock_update_matches_eager(card):
    """The merge chunk's stock update (``apply_neworder``'s local lines of
    a 256-order batch, the padding lines masked) captured in a CUDA graph
    and replayed twice equals two eager applies, bit for bit."""
    scale = _stock_scale(64)
    state = _stock_state(scale, 4, card)
    batch = tpcc.generate_neworder(np.random.default_rng(4), scale, 256,
                                   remote_frac=0.01, device=card)
    flat = tpcc.flatten_order_lines(batch, 0, scale.n_warehouses)
    mask = tpcc.order_line_valid(batch).reshape(-1) & flat.local
    args = (flat.w, flat.i, flat.q, mask, flat.remote)
    want = tpcc.copy_tree(state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpcc.apply_stock_updates(tpcc.copy_tree(state), *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tpcc.apply_stock_updates(state, *args)
    for _ in range(2):
        graph.replay()
        tpcc.apply_stock_updates(want, *args)
    torch.cuda.synchronize()
    assert int((~mask).sum()) > 0
    for name in ("s_quantity", "s_ytd", "s_order_cnt", "s_remote_cnt"):
        x, y = getattr(state, name), getattr(want, name)
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name


@pytest.mark.parametrize("mode", ["recover", "revive"])
def test_pod_simulator_on_the_card_matches_the_cpu(cuda, tmp_path, mode):
    """The escrow pod simulator through a failure: ``recover``, replica 2
    checkpointed and killed, then recovered from the checkpoint (the
    omniscient caller); ``revive``, self-detecting mode with reservations,
    replica 2 killed, detected, adopted by its successor and revived. Each
    step goes through the megastep (B2) on the card, bit-equal to the same
    simulator on the CPU (state, escrow, rings, queues, ledger); the cold
    ledger is exact and the card's state audits."""
    from repro_torch.runtime.failures import EscrowPodSimulator

    scale = tpcc.TPCCScale(n_warehouses=4, districts=2, customers=16,
                           n_items=64, order_capacity=1024, max_lines=15)
    live = mode == "revive"
    sims = [EscrowPodSimulator(scale, 4, retry_cap=128, retry_max=3,
                               seed=11, stock_scale=3, liveness=live,
                               reserve=live, device=dev)
            for dev in ("cpu", cuda)]
    txn_megastep_cuda.launches = 0
    serving = 0
    for t in range(10):
        for i, sim in enumerate(sims):
            if t == 3:
                if not live:
                    sim.checkpoint(str(tmp_path / str(i)), step=t)
                sim.kill(2)
            if t == 7:
                if live:
                    sim.revive(2)
                else:
                    sim.recover(2, str(tmp_path / str(i)))
            if i == 1:
                serving += sum(sim._serving(r) for r in range(4))
            sim.step(16, remote_frac=0.5, item_skew=1.2)
            sim.drain()
            sim.refresh()
    for sim in sims:
        sim.quiesce()
        sim.refresh()
    cpu, card = sims
    assert txn_megastep_cuda.launches == serving > 0
    assert card.hot_keys.device.type == "cuda"
    for a, b in ((cpu.full_state(), card.full_state()), (cpu.esc, card.esc),
                 *zip(cpu.rings, card.rings)):
        assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))
    assert (cpu.pending, cpu.committed, cpu.cold_ledger()) == \
        (card.pending, card.committed, card.cold_ledger())
    if live:
        assert card.monitor.detections == cpu.monitor.detections != []
    assert card.cold_ledger()["exact"] and card.audit().ok


def test_restore_run_onto_the_card_matches_the_cpu(cuda, tmp_path):
    """A run image of four replicas saved with ``final_flush=False`` and
    restored through ``restore_run(engine)``: every leaf lands on the
    card, bit-equal to the saved image and to the CPU's restore of the
    CPU's run; the two resume to the same end."""
    from repro_torch.txn import assert_audit, restore_run, run_loop, save_run
    from repro_torch.txn.engine import Engine

    scale = tpcc.TPCCScale(n_warehouses=4, districts=2, customers=8,
                           n_items=32, order_capacity=512, max_lines=15)
    kw = dict(batch_per_shard=8, n_batches=8, remote_frac=0.6,
              merge_every=4, refresh_every=1, seed=3, item_skew=1.5,
              retry_cap=256, retry_max=3, return_retry=True)
    ends = []
    for dev, admission, effects in (("cpu", "scan", "scan"),
                                    (cuda, "kernel", "fused")):
        e = Engine(scale, stock_invariant="strict", admission=admission,
                   effects=effects, device=dev, n_shards=4)
        s, esc, _, ring = run_loop(e, tpcc.init_state(scale, device=dev),
                                   final_flush=False, **kw)
        d = str(tmp_path / str(dev))
        save_run(d, s, 8, esc=esc, retry=ring)
        rr = restore_run(d, e)
        leaves = [*rr.state, *rr.esc, *rr.retry]
        assert all(x.device.type == torch.device(dev).type for x in leaves)
        assert all(torch.equal(x, y)
                   for x, y in zip(leaves, [*s, *esc, *ring]))
        s2, esc2, st2, ring2 = run_loop(e, rr.state, rr.esc, retry=rr.retry,
                                        **dict(kw, seed=4))
        assert_audit(s2, escrow=esc2, strict_stock=True, initial_stock=(
            tpcc.init_state(scale, device="cpu").s_quantity))
        ends.append(([x.cpu() for x in (*s2, *esc2, *ring2)],
                     (st2.neworders, st2.aborts, st2.cold_rejects)))
    (want, counts), (got, c) = ends
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert c == counts


FUSED_ROWS = {
    "merge mix": ({}, dict(payments=True, reads=True, deliveries=True)),
    "escrow, txn_megastep, mix": (
        dict(stock_invariant="strict", admission="kernel", effects="fused"),
        dict(payments=True, reads=True, deliveries=True, refresh_every=2)),
    "escrow, escrow_admit": (
        dict(stock_invariant="strict", admission="kernel", effects="scan"),
        dict(refresh_abort_rate=0.3)),
}


@pytest.mark.parametrize("row", list(FUSED_ROWS))
@pytest.mark.parametrize("R", [1, 4])
def test_fused_executor_on_the_card_matches_dispatch(cuda, R, row):
    """``run_loop(fused=True)``: each chunk one CUDA graph replay (a
    shorter last chunk its own graph), bit-equal to the dispatch path on
    the card and to the fused path on the CPU (state, escrow, counts); B1,
    B2 and B3 counted through the replays, as many as the dispatch path
    launches."""
    from repro_torch.txn import run_loop
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import get_fused_executor

    scale = tpcc.TPCCScale(n_warehouses=8, districts=4, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    ekw, knobs = FUSED_ROWS[row]
    kw = dict(batch_per_shard=16, n_batches=7, remote_frac=0.3,
              merge_every=3, seed=5, item_skew=1.2, hot_items=4, **knobs)
    hot = kw.pop("hot_items")
    runs = {}
    for dev, fused in (("cpu", True), (cuda, False), (cuda, True)):
        e = Engine(scale, device=dev, n_shards=R,
                   **(dict(ekw, hot_items=hot) if ekw else {}))
        state = tpcc.init_state(scale, device=dev)
        for k in (escrow_admit_cuda, txn_megastep_cuda, ramp_read_cuda):
            k.launches = 0
        s, esc, st = run_loop(e, state, fused=fused, audit=True, **kw)
        launches = tuple(k.launches for k in (escrow_admit_cuda,
                                              txn_megastep_cuda,
                                              ramp_read_cuda))
        runs[(str(dev), fused)] = (
            [x.cpu() for x in (*s, *(esc or ()))],
            (st.neworders, st.aborts, st.refreshes, st.payments,
             st.reads_found, st.deliveries, st.anti_entropy_rounds),
            launches)
        if dev != "cpu" and fused:
            graphs = get_fused_executor(
                e, ring_rows=3, deliveries="deliveries" in knobs
            ).last_run["graphs"]
            assert sorted(graphs) == [1, 3]           # chunks 3, 3, 1
            assert [g.replays for g in graphs.values()] == [1, 2]
            assert all(g.pool_bytes >= 0 for g in graphs.values())
    want, counts, _ = runs[("cpu", True)]
    assert counts[0] > 0
    _, _, dispatch = runs[(str(cuda), False)]
    assert sum(dispatch) > 0
    for key, (got, c, launches) in runs.items():
        assert all(torch.equal(x, y) for x, y in zip(got, want)), key
        assert c == counts, key
        if key[0] != "cpu":
            assert launches == dispatch, key


def test_fused_capture_raises_instead_of_falling_back(cuda):
    """A chunk body that reads back to the host cannot be captured: the
    warm-up's host-sync check raises, and without the warm-up the capture
    itself raises; neither runs the chunk eagerly (the live state is
    untouched), and the next run on the card captures and runs."""
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import FusedExecutor, stack_chunks

    scale = tpcc.TPCCScale(n_warehouses=4, districts=4, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    e = Engine(scale, device=cuda)
    chunks = stack_chunks(*generate_mix_batches(
        e, batch_per_shard=8, n_batches=4, seed=1), 2)
    state = tpcc.init_state(scale, device=cuda)
    before = [x.clone() for x in state]
    honest = e.delivery_step

    def reads_back(st):
        int(st.no_valid.sum())          # a host read, inside the chunk
        return honest(st)
    e.delivery_step = reads_back
    ex = FusedExecutor(e, ring_rows=2)
    for warmup in (True, False):
        with pytest.raises(RuntimeError):
            ex.run(state, chunks, warmup=warmup)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(state, before))
    e.delivery_step = honest
    s, counters, _ = ex.run(state, chunks)
    assert int(counters.neworders.sum()) == 4 * 8
    assert sorted(ex.last_run["graphs"]) == [2]


OBS_ROWS = {k: FUSED_ROWS[k] for k in ("merge mix",
                                       "escrow, txn_megastep, mix")}


# the executor's spans of its call's set-up and close, which it opens on
# the card only, and each one's parent
CALL_SPANS = {"call-setup": None, "release": "call-setup",
              "buffers": "call-setup", "warm": "call-setup",
              "capture": "call-setup", "capture-wait": "capture",
              "collect": "capture", "cache-release": "capture",
              "graph-record": "capture", "loop-wait": "call-setup",
              "call-close": None}
# the merge drain's spans inside each timed "outbox-drain", also the card's
# alone (the executor hands the drain its call span)
DRAIN_SPANS = ("outbox-gather", "owner-apply")


def _exact_snapshot(snap):
    """A snapshot without the fields derived from wall time, its spans
    those the CPU opens too."""
    out = {k: snap[k] for k in ("latency", "counters", "item_access")}
    for row in out["latency"].values():
        row.pop("p50_s")
        row.pop("p99_s")
    stats = dict(snap["stats"])
    stats.pop("wall_seconds")
    stats.pop("throughput")
    out["stats"] = stats
    out["spans"] = {p: v["count"] for p, v in snap["spans"]["phases"].items()
                    if p not in CALL_SPANS and p not in DRAIN_SPANS}
    return out


@pytest.mark.parametrize("row", list(OBS_ROWS))
@pytest.mark.parametrize("R", [1, 4])
def test_metrics_on_replays_bit_equal_to_metrics_off(cuda, R, row):
    """``run_loop(obs=ObsSession(metrics=True))`` on the card ends bit-equal
    to ``obs=None`` (state, escrow, counts, B1-B3 launches); in the merge
    regime each graph captured the same launches into the same pool bytes;
    its snapshot equals the CPU's metrics-on snapshot in every exact
    field."""
    from repro_torch.obs import ObsSession
    from repro_torch.txn import run_loop
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import get_fused_executor

    scale = tpcc.TPCCScale(n_warehouses=8, districts=4, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    ekw, knobs = OBS_ROWS[row]
    kw = dict(batch_per_shard=16, n_batches=7, remote_frac=0.3,
              merge_every=3, seed=5, item_skew=1.2, **knobs)
    runs = {}
    for dev, metrics in (("cpu", True), (cuda, False), (cuda, True)):
        e = Engine(scale, device=dev, n_shards=R,
                   **(dict(ekw, hot_items=4) if ekw else {}))
        for k in (escrow_admit_cuda, txn_megastep_cuda, ramp_read_cuda):
            k.launches = 0
        obs = ObsSession(metrics=True, trace=True) if metrics else None
        s, esc, st = run_loop(e, tpcc.init_state(scale, device=dev), obs=obs,
                              **kw)
        launches = tuple(k.launches for k in (escrow_admit_cuda,
                                              txn_megastep_cuda,
                                              ramp_read_cuda))
        snap = None if obs is None else _exact_snapshot(obs.snapshot())
        if obs is not None and dev != "cpu":     # run_loop's one call
            assert obs.tracer.phases["call-setup"].count == 1
        st.wall_seconds = 0.0
        graphs = {}
        if dev != "cpu":
            graphs = {T: (dict(g.launches), g.pool_bytes, g.replays)
                      for T, g in get_fused_executor(
                          e, ring_rows=3, deliveries=True
                      ).last_run["graphs"].items()}
        runs[(str(dev), metrics)] = (
            [x.cpu() for x in (*s, *(esc or ()))], st, launches, graphs,
            snap)
    want = runs[("cpu", True)]
    off = runs[(str(cuda), False)]
    on = runs[(str(cuda), True)]
    for got in (off, on):
        assert all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
        assert got[1] == want[1]
    assert on[2] == off[2] and sum(on[2]) > 0
    assert on[4] == want[4]
    assert sorted(on[3]) == sorted(off[3]) == [1, 3]
    if not ekw:   # the merge regime's chunk is the metrics-off graph
        assert on[3] == off[3]
    else:         # the escrow regime's adds the commit-mask write only
        assert {T: g[0] for T, g in on[3].items()} == \
            {T: g[0] for T, g in off[3].items()}


@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_call_spans_on_the_card(cuda, regime):
    """Two executor calls with spans on the same tables, the first with its
    warm-up: the first call opens one ``capture`` a distinct chunk length
    under ``call-setup`` and the second, which replays the kept graphs,
    none; every call span opens under its parent; the final state
    is bit-equal to the same calls without spans; and
    ``portbench.tracing.summarize`` counts none of the call spans'
    profiler ranges as device work."""
    from portbench import tracing
    from repro_torch.obs import ObsSession
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import FusedExecutor, stack_chunks

    scale = tpcc.TPCCScale(n_warehouses=4, districts=4, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    escrow = regime == "escrow"
    e = Engine(scale, device=cuda, **(dict(
        stock_invariant="strict", hot_items=4, admission="kernel",
        effects="fused") if escrow else {}))
    chunks = stack_chunks(*generate_mix_batches(
        e, batch_per_shard=8, n_batches=5, remote_frac=0.3, seed=3), 2)
    ex = FusedExecutor(e, ring_rows=2)              # chunks of 2, 2 and 1
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    finals = {}
    for traced in (False, True):
        state = tpcc.init_state(scale, device=cuda)
        esc = e.init_escrow(state) if escrow else None
        obs = ObsSession(metrics=False, trace=True) if traced else None
        with torch.profiler.profile(activities=acts) as prof:
            for warmup in (True, False):
                with torch.profiler.record_function(tracing.PASS):
                    if escrow:
                        state, esc, counters, *_ = ex.run_escrow(
                            state, esc, chunks, warmup=warmup, obs=obs)
                    else:
                        state, counters, _ = ex.run(state, chunks,
                                                    warmup=warmup, obs=obs)
        finals[traced] = [x.cpu() for x in (*state, *(esc or ()),
                                            *counters)]
    phases = obs.tracer.phases
    assert {k: p.parent for k, p in phases.items() if k in CALL_SPANS} == \
        CALL_SPANS
    counts = {k: p.count for k, p in phases.items()}
    assert counts["call-setup"] == counts["call-close"] == 2
    assert counts["warm"] == 1
    for k in ("capture", "capture-wait", "collect", "cache-release",
              "graph-record"):
        assert counts[k] == 2, k          # lengths 2 and 1, the first call
    assert counts["megastep"] == 2 * 3
    assert int(counters.neworders.sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(finals[False],
                                                 finals[True]))
    summary = tracing.summarize(prof)
    assert summary.n_device_events > 0
    assert not set(summary.kernel_s) & set(CALL_SPANS)


def _kept_calls(cuda, escrow):
    """An engine on the card, chunks of 2, 2 and 1 steps of the mix, an
    executor with its ring of 2, fresh tables and escrow, and ``call(ex,
    state, esc, chunks, obs)``, which returns the state and escrow
    (copied to the host) and the counters' totals."""
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import FusedExecutor, stack_chunks

    scale = tpcc.TPCCScale(n_warehouses=4, districts=4, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    e = Engine(scale, device=cuda, **(dict(
        stock_invariant="strict", hot_items=4, admission="kernel",
        effects="fused") if escrow else {}))
    chunks = stack_chunks(*generate_mix_batches(
        e, batch_per_shard=8, n_batches=5, remote_frac=0.3, seed=3), 2)
    state = tpcc.init_state(scale, device=cuda)
    esc = e.init_escrow(state) if escrow else None

    def call(ex, state, esc, chunks, obs):
        if escrow:
            s, esc, c, *_ = ex.run_escrow(state, esc, chunks, obs=obs)
        else:
            s, c, _ = ex.run(state, chunks, obs=obs)
        return ([x.cpu() for x in (*s, *(esc or ()))],
                tuple(int(x.sum()) for x in c))
    return e, FusedExecutor(e, ring_rows=2), chunks, state, esc, call


def _captures(obs) -> int:
    phase = obs.tracer.phases.get("capture")
    return 0 if phase is None else phase.count


@pytest.mark.parametrize("regime", ["merge", "escrow"])
def test_second_call_replays_the_kept_graphs(cuda, regime):
    """A second call on the same tables, restored in place from a snapshot,
    opens no ``capture`` span and ends bit-equal to the first call from
    that snapshot (state, escrow, counts); each kept graph's ``replays``
    count that call's alone; a call on a new state tensor captures once
    more and ends the same."""
    from repro_torch.obs import ObsSession

    escrow = regime == "escrow"
    _, ex, chunks, state, esc, call = _kept_calls(cuda, escrow)
    live = [*state, *(esc or ())]
    snap = [x.clone() for x in live]
    runs = []
    for fresh in (False, False, True):
        if fresh:
            state = tpcc.TPCCState(*(x.clone() for x in snap[:len(state)]))
            esc = None if esc is None else type(esc)(
                *(x.clone() for x in snap[len(state):]))
        else:
            for x, y in zip(live, snap):
                x.copy_(y)
        obs = ObsSession(metrics=False, trace=True)
        out = call(ex, state, esc, chunks, obs)
        runs.append((_captures(obs), out))
        assert {T: g.replays for T, g in ex.last_run["graphs"].items()} == \
            {1: 1, 2: 2}
    assert [n for n, _ in runs] == [2, 0, 2]       # lengths 2 and 1
    (_, (want, counts)), *rest = runs
    assert counts[0] > 0
    for _, (got, c) in rest:
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert c == counts


def test_metrics_on_escrow_recaptures_for_another_chunk_count(cuda):
    """A metrics-on escrow call keeps its commit-mask buffer: a second
    call with as many chunks replays on it, and one with another count
    recaptures on a new buffer; each call's lattice equals a new
    executor's call on a copy of the same tables."""
    from repro_torch.obs import ObsSession
    from repro_torch.txn.executor import FusedExecutor

    e, ex, chunks, state, esc, call = _kept_calls(cuda, True)
    # two chunks of the lengths 2 and 1, the first recording the stream's
    # Payment rounds: only the chunk count differs from the stream's key
    rounds = max(c.pay_rounds for c in chunks if c.chunk_len == 2)
    fewer = [chunks[0]._replace(pay_rounds=rounds), chunks[2]]

    def lattice(ex, state, esc, part):
        obs = ObsSession(metrics=True, trace=True)
        call(ex, state, esc, part, obs)
        return _captures(obs), [x.cpu() for m in obs.device_metrics
                                for x in m]

    for part, captures in ((chunks, 2), (chunks, 0), (fewer, 2)):
        copy = tpcc.copy_tree(state), tpcc.copy_tree(esc)
        n, got = lattice(ex, state, esc, part)
        assert n == captures
        assert ex._kept.oks.buf.shape[0] == len(part)
        assert int(ex._kept.oks.cursor) == len(part)
        _, want = lattice(FusedExecutor(e, ring_rows=2), *copy, part)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert int(got[1].sum()) > 0                # committed New-Orders


@pytest.mark.parametrize("R", [1, 4])
def test_drain_spans_on_the_card(card, R):
    """A traced merge run at R shards opens, inside each timed
    ``outbox-drain``, one ``outbox-gather`` and an ``owner-apply`` a
    shard (the warm-up's drain none); its final tables and counters are
    bit-equal to the same run without a session."""
    from repro_torch.obs import ObsSession
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import FusedExecutor, stack_chunks

    scale = tpcc.TPCCScale(n_warehouses=8, districts=2, customers=8,
                           n_items=64, order_capacity=64, max_lines=15)
    e = Engine(scale, n_shards=R, device=card)
    no_b = generate_mix_batches(e, batch_per_shard=8, n_batches=6,
                                remote_frac=0.3, seed=5)[0]
    chunks = stack_chunks(no_b, None, None, None, 2)
    ex = FusedExecutor(e, ring_rows=2)
    finals = {}
    for traced in (False, True):
        state = tpcc.init_state(scale, device=card)
        obs = ObsSession(metrics=False, trace=True) if traced else None
        state, counters, _ = ex.run(state, chunks, obs=obs)
        finals[traced] = [x.cpu() for x in (*state, *counters)]
    phases = obs.tracer.phases
    drains = phases["outbox-drain"].count
    assert drains == 3 and phases["outbox-drain"].parent is None
    assert {k: (phases[k].parent, phases[k].count)
            for k in ("outbox-gather", "owner-apply")} == {
        "outbox-gather": ("outbox-drain", drains),
        "owner-apply": ("outbox-drain", R * drains)}
    assert int(counters.neworders.sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(finals[False],
                                                 finals[True]))


def test_item_access_scatter_on_the_card_matches_the_cpu(cuda):
    """Full width: 8 steps x 256 New-Orders x 15 lines against 100,000
    items takes the scatter branch (``index_add_`` on int32); on the card
    it equals the plain sum on the CPU."""
    from repro_torch.obs import metrics as obsm

    T, B, L, n_items, R = 8, 256, 15, 100_000, 4
    rng = np.random.default_rng(0)
    fields = dict(i_id=rng.integers(0, n_items, (T, B, L), dtype=np.int32),
                  n_lines=rng.integers(5, L + 1, (T, B), dtype=np.int32),
                  supply_w=rng.integers(0, 2, (T, B, L), dtype=np.int32),
                  w=np.zeros((T, B), np.int32))
    assert T * (B // R) * L * n_items > obsm._ONE_HOT_MAX_ELEMS
    ok = rng.integers(0, 2, (T, B)).astype(bool)

    class _NO:
        pass

    out = {}
    for dev in ("cpu", cuda):
        no = _NO()
        for k, v in fields.items():
            setattr(no, k, torch.from_numpy(v).to(dev))
        m = obsm.record_chunk(obsm.make_obs_metrics(R, n_items, device=dev),
                              no, torch.from_numpy(ok).to(dev))
        out[str(dev)] = obsm.metrics_to_host(m)
    valid = np.arange(L)[None, None] < fields["n_lines"][..., None]
    plain = np.zeros((R, n_items), np.int64)
    for r in range(R):
        blk = slice(r * B // R, (r + 1) * B // R)
        np.add.at(plain[r], fields["i_id"][:, blk][valid[:, blk]], 1)
    for host in out.values():
        assert np.array_equal(host.item_access.slots.numpy(), plain)
    assert torch.equal(out["cpu"].latency.counts,
                       out[str(cuda)].latency.counts)


# ---------------------------------------------------------------------------
# The shape-only routes (the dry run's) against the kernels
# ---------------------------------------------------------------------------


def _route_problem(kernel, device):
    """A small seeded problem for ``kernel``'s wrapper on ``device``:
    (wrapper, arguments, keywords, the operations the kernel states)."""
    from repro_torch.kernels import flash_attention, rwkv6_scan
    from repro_torch.kernels import ramp_read as rr
    from repro_torch.kernels import txn_megastep as tm

    g = torch.Generator().manual_seed(0)
    B, L, A = 12, 15, 40
    ints = lambda hi, *s: torch.randint(0, hi, s, generator=g,  # noqa: E731
                                        dtype=torch.int32)
    if kernel in ("escrow_admit", "txn_megastep"):
        avail0, slot, qty = ints(30, A), ints(A, B, L), ints(9, B, L) + 1
        lv = torch.rand((B, L), generator=g) < 0.7
        fast = contention_gate(avail0, slot, qty, lv)[0]
        args = [avail0, slot, qty, lv, fast, *residual_order(fast)]
        if kernel == "escrow_admit":
            return escrow_admit_cuda, [x.to(device) for x in args], {}, 0
        local = torch.rand((B, L), generator=g) < 0.8
        args += [ints(5, B), ints(30, B, L), local, ~local & lv, ints(99, B),
                 torch.rand((B, L), generator=g)]
        return (txn_megastep_cuda, [x.to(device) for x in args],
                dict(n_keys=5, n_cells=30), tm.operations(B, L))
    if kernel == "ramp_read":
        R = 9
        args = [ints(4, R), ints(11, R) + 5, ints(4, R, L),
                torch.rand((R, L), generator=g) < 0.6,
                torch.rand((R, L), generator=g) < 0.5,
                torch.rand((R, L), generator=g), ints(99, R, L)]
        return (ramp_read_cuda, [x.to(device) for x in args], {},
                rr.operations(R, L))
    if kernel == "flash_attention":
        B, S, H, KV, hd = 2, 13, 6, 2, 64
        args = [torch.randn((B, S, h, hd), generator=g).to(torch.bfloat16)
                for h in (H, KV, KV)]
        return (flash_attention.flash_attention_cuda,
                [x.to(device) for x in args], dict(causal=True),
                flash_attention.operations(B, S, H, hd, True))
    B, T, H, hd = 2, 21, 3, 64
    n = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    args = [n(B, T, H, hd), n(B, T, H, hd), n(B, T, H, hd),
            torch.rand((B, T, H, hd), generator=g) * 0.5 + 0.4, n(H, hd),
            n(B, H, hd, hd)]
    return (rwkv6_scan.rwkv6_scan_cuda, [x.to(device) for x in args], {},
            rwkv6_scan.operations(B, T, H, hd))


@pytest.mark.parametrize("kernel", ["escrow_admit", "txn_megastep",
                                    "ramp_read", "flash_attention",
                                    "rwkv6_scan"])
def test_shape_only_route_matches_the_kernel(cuda, kernel):
    """On fake CUDA tensors (FakeTensorMode) the wrapper returns the real
    launch's shapes and dtypes and counts the operations FlopCounterMode
    reports around the real launch, launching nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    wrapper, args, kw, n_ops = _route_problem(kernel, cuda)
    with FlopCounterMode(display=False) as fc:
        real = wrapper(*args, **kw)
    torch.cuda.synchronize()
    real = real if isinstance(real, tuple) else (real,)
    launches = wrapper.launches
    with FakeTensorMode():
        fake_args = [torch.empty(x.shape, dtype=x.dtype, device="cuda")
                     for x in args]
        with FlopCounterMode(display=False) as fake_fc:
            fake = wrapper(*fake_args, **kw)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(x.shape, x.dtype) for x in fake] == \
        [(x.shape, x.dtype) for x in real]
    assert fake_fc.get_flop_counts() == fc.get_flop_counts()
    assert fc.get_total_flops() == n_ops
    assert wrapper.launches == launches


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b"])
def test_prefill_trace_matches_the_card(cuda, arch):
    """A reduced prefill traced on meta tensors (B5/B6 on their shape-only
    routes) and run on the card (the kernels) under the dry run's
    counters: FLOPs, the kernels' operations and the ops kind by kind
    equal."""
    from repro_torch.configs import registry
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L

    cfg = registry.get_config(arch).reduced()
    step = dryrun.prefill_step(cfg)
    tokens = torch.empty((2, 33), dtype=torch.int32, device="meta")
    traced, _ = dryrun.trace(step, (dryrun.serving_params_abs(cfg),
                                    {"tokens": tokens}))
    dt = L.dtype_of(cfg)
    params = T.map(lambda x: x.to(dt) if x.is_floating_point() else x,
                   L.stacked(registry.init_params(cfg, 0, "cuda")))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 33), device="cuda",
                                     dtype=torch.int32)}
    ran, _ = dryrun.trace(step, (params, batch))
    assert traced["cost"] == ran["cost"]
    assert traced["ops"]["kinds"] == ran["ops"]["kinds"]
    kernel = "flash_attention" if cfg.family == "dense" else "rwkv6_scan"
    assert traced["cost"]["by_op"][f"repro_torch.{kernel}"] > 0
