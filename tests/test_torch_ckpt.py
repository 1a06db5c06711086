"""The port's checkpoint layer against the JAX package's.

Each case of the reference's ``tests/test_ckpt.py`` runs against
``repro_torch.ckpt.checkpoint`` (manifest lattice, concurrent writers,
dense sequential IDs, restore onto a device, a crash mid-commit, truncated
manifests and SEQUENCE, temp generations by writer time, a digit-prefixed
temp id). Then the two packages' files cross: the same trees save under
the same leaf names and npz keys, a run image the JAX package's
``save_run`` writes restores in the port's ``restore_run`` bit for bit
(with an engine, both escrow layouts, and host-side), and one the port
writes restores in the reference's. Restore casts to the template's dtype
in both directions (int64 stamps to int32 and back, bools stay bools).

Tolerance: exact, values and dtypes.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jck  # noqa: E402
from repro.txn import recovery as jrec  # noqa: E402
from repro.txn import tpcc as jt  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.core.lattice import EscrowCounter, HotSetEscrow  # noqa: E402
from repro_torch.txn import recovery as trec  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.engine import single_host_engine  # noqa: E402


def _state():
    return {"params": {"w": torch.arange(8.0), "b": torch.ones((2, 3))},
            "step": torch.tensor(5, dtype=torch.int32)}


def _leaves_equal(a, b) -> bool:
    fa, fb = ck._flatten_with_names(a), ck._flatten_with_names(b)
    return [n for n, _ in fa] == [n for n, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


# ---------------------------------------------------------------------------
# the reference's cases, against the port
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        man = ck.save(d, s, step=5)
        assert ck.is_complete(man, s)
        out = ck.restore(d, man, s)
        assert _leaves_equal(s, out)


def test_concurrent_writers_merge_to_complete_manifest():
    """Two writers each save half the tree; manifests join (or-join on the
    shard set) into a complete checkpoint — no write barrier needed."""
    s = _state()
    names = [n for n, _ in ck._flatten_with_names(s)]
    half1, half2 = set(names[:2]), set(names[2:])
    with tempfile.TemporaryDirectory() as d:
        m1 = ck.save(d, s, step=7, writer="w1", partial=half1)
        m2 = ck.save(d, s, step=7, writer="w2", partial=half2)
        m2 = dataclasses.replace(m2, temp_id=m1.temp_id)  # same logical ckpt
        assert not ck.is_complete(m1, s)
        assert not ck.is_complete(m2, s)
        merged = ck.merge_manifests([m1, m2])
        assert ck.is_complete(merged, s)
        out = ck.restore(d, merged, s)
        assert torch.equal(out["params"]["w"], s["params"]["w"])
        assert _leaves_equal(s, out)


def test_manifest_join_laws():
    a = ck.Manifest(step=3, temp_id="t", shards={"x": "f1"},
                    writer_meta={"w1": {}})
    b = ck.Manifest(step=5, temp_id="t", shards={"y": "f2"},
                    writer_meta={"w2": {}})
    ab = ck.Manifest.join(a, b)
    ba = ck.Manifest.join(b, a)
    assert ab.step == ba.step == 5
    assert ab.shards == ba.shards == {"x": "f1", "y": "f2"}
    assert ck.Manifest.join(ab, ab).shards == ab.shards  # idempotent
    # the JSON is the reference's, field for field
    ja = jck.Manifest(**dataclasses.asdict(ab))
    assert ja.to_json() == ab.to_json()
    assert ck.Manifest.from_json(ja.to_json()) == ab


def test_sequential_assignment_is_dense():
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        ids = []
        for step in (1, 2, 3):
            man = ck.save(d, s, step=step)
            man = ck.assign_sequential(d, man)
            ids.append(man.seq_id)
        assert ids == [0, 1, 2]  # dense, no gaps (single assigner)
        assert ck.latest_manifest(d).seq_id == 2
        # the reference reads the same directory the same way
        assert jck.latest_manifest(d).to_json() == \
            ck.latest_manifest(d).to_json()
        with open(os.path.join(d, "SEQUENCE")) as f:
            assert f.read() == "2"


def test_restore_onto_a_device_from_a_meta_template():
    """Arrays are stored whole; restore builds the template's tree (here
    meta tensors, which allocate nothing) on the device it is given, cast
    to the template's dtypes."""
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        man = ck.save(d, s, step=1)
        meta = {"params": {"w": torch.empty(8, device="meta"),
                           "b": torch.empty((2, 3), dtype=torch.float64,
                                            device="meta")},
                "step": torch.empty((), dtype=torch.int64, device="meta")}
        out = ck.restore(d, man, meta, device="cpu")
        assert out["params"]["b"].dtype == torch.float64
        assert out["step"].dtype == torch.int64 and int(out["step"]) == 5
        assert out["params"]["b"].device == torch.device("cpu")
        assert torch.equal(out["params"]["b"].float(), s["params"]["b"])


def test_mid_commit_crash_leaves_previous_committed(monkeypatch):
    """The writer dies between bumping SEQUENCE and publishing the
    committed manifest: ``latest_manifest`` returns the previous committed
    checkpoint, never a parse error or a truncated manifest."""
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        committed0 = ck.assign_sequential(d, ck.save(d, s, step=1))
        man1 = ck.save(d, s, step=2)
        real_replace = os.replace

        def crash_on_manifest(src, dst):
            if dst.endswith(".manifest.json"):
                raise RuntimeError("killed mid-commit")   # power cut
            return real_replace(src, dst)

        monkeypatch.setattr(ck.os, "replace", crash_on_manifest)
        with pytest.raises(RuntimeError):
            ck.assign_sequential(d, man1)
        monkeypatch.setattr(ck.os, "replace", real_replace)
        latest = ck.latest_manifest(d)
        assert latest is not None
        assert latest.seq_id == committed0.seq_id == 0
        assert latest.step == 1
        man2 = ck.assign_sequential(d, ck.save(d, s, step=3))
        assert ck.latest_manifest(d).seq_id == man2.seq_id


def test_truncated_manifests_and_sequence_are_skipped():
    """A truncated committed manifest is skipped in favor of the previous
    committed one, and a garbage SEQUENCE is re-derived from the committed
    IDs."""
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        man0 = ck.assign_sequential(d, ck.save(d, s, step=1))
        good = ck.save(d, s, step=2)
        with open(os.path.join(d, "ckpt-000001.manifest.json"), "w") as f:
            f.write(good.to_json()[:25])          # half-written JSON
        assert ck.latest_manifest(d).seq_id == man0.seq_id == 0
        with open(os.path.join(d, "SEQUENCE"), "w") as f:
            f.write("1x")                         # truncated counter
        man2 = ck.assign_sequential(d, ck.save(d, s, step=3))
        assert man2.seq_id == 2                   # max committed id + 1
        assert ck.latest_manifest(d).seq_id == 2


def test_newest_temp_is_by_writer_time_not_filename():
    """Two temp generations written out of lexical order resolve to the
    newest writer_meta timestamp."""
    def _write_temp(d, temp_id, t, step):
        man = ck.Manifest(step=step, temp_id=temp_id,
                          shards={"x": f"{temp_id}-w0.npz"},
                          writer_meta={"w0": {"time": t, "n_shards": 1}})
        with open(os.path.join(d, f"{temp_id}-w0.manifest.json"), "w") as f:
            f.write(man.to_json())

    with tempfile.TemporaryDirectory() as d:
        _write_temp(d, "zz-old-gen", t=100.0, step=1)   # sorts LAST
        _write_temp(d, "aa-new-gen", t=200.0, step=2)   # sorts first
        latest = ck.latest_manifest(d)
        assert latest.temp_id == "aa-new-gen" and latest.step == 2


def test_digit_prefixed_temp_id_does_not_shadow_committed():
    """A temp manifest whose id begins with six digits never sorts above a
    committed ckpt-NNNNNN manifest."""
    s = _state()
    with tempfile.TemporaryDirectory() as d:
        man = ck.save(d, s, step=1)
        committed = ck.assign_sequential(d, man)
        shadow = dataclasses.replace(man, temp_id="ckpt-999999aaaaaa")
        with open(os.path.join(d, "ckpt-999999aaaaaa-w0.manifest.json"),
                  "w") as f:
            f.write(shadow.to_json())
        assert ck.latest_manifest(d).seq_id == committed.seq_id == 0


# ---------------------------------------------------------------------------
# the two packages' files cross
# ---------------------------------------------------------------------------

SCALE = (4, 2, 8, 32, 64, 15)


def _run_image(layout, n_shards=1, seed=0):
    """A run image of the reference with every leaf seeded: state, escrow
    of ``layout`` from its engine, a ``[n_shards, 6]`` ring."""
    rng = np.random.default_rng(seed)
    scale = jt.TPCCScale(*SCALE)
    st = jt.init_state(scale, seed=seed)
    st = st._replace(
        s_quantity=jnp.asarray(rng.integers(0, 99, st.s_quantity.shape),
                               jnp.int32),
        ol_vis=jnp.asarray(rng.random(st.ol_vis.shape) < 0.3),
        ol_amount=jnp.asarray(rng.random(st.ol_amount.shape), jnp.float32))
    je = jengine(scale, stock_invariant="strict", escrow_layout=layout)
    esc = je.init_escrow(je.shard_state(st))
    if n_shards > 1:
        esc = type(esc)(*(x if x.ndim == 1 else jnp.tile(x, (n_shards,) + (
            1,) * (x.ndim - 1)) for x in esc))
    ints = lambda: jnp.asarray(rng.integers(0, 50, (n_shards, 6)), jnp.int32)
    bools = lambda: jnp.asarray(rng.random((n_shards, 6)) < 0.5)
    ring = jt.RetryState(ints(), ints(), ints(), ints(), bools(), bools())
    return st, esc, ring


def _npz_keys(d):
    [f] = [f for f in os.listdir(d) if f.endswith(".npz")]
    with np.load(os.path.join(d, f)) as z:
        return list(z.keys())


def _same(j, t) -> list[str]:
    j = type(j)(*(np.asarray(x) for x in jax.device_get(j)))
    t = state_to_numpy(t)
    return [f for f, x, y in zip(t._fields, j, t)
            if x.dtype != y.dtype or not np.array_equal(x, y)]


PORT_TYPES = {"TPCCState": tt.TPCCState, "RetryState": tt.RetryState,
              "HotSetEscrow": HotSetEscrow, "EscrowCounter": EscrowCounter}


def _port_image(image):
    """A reference run image as the port's types, on the CPU."""
    return tuple(PORT_TYPES[type(x).__name__](*(
        torch.from_numpy(np.array(v)) for v in jax.device_get(x)))
        for x in image)


def test_same_trees_save_under_the_same_names(tmp_path):
    """Leaf names, npz keys (in order) and the manifest's shard set are the
    reference's: ``state/.s_quantity``, ``esc/.shares``, ``retry/.dst_w``."""
    image = _run_image("sparse")
    man_j = jrec.save_run(str(tmp_path / "j"), image[0], 3, esc=image[1],
                          retry=image[2])
    tst, tesc, tring = _port_image(image)
    man_t = trec.save_run(str(tmp_path / "t"), tst, 3, esc=tesc, retry=tring)
    assert sorted(man_j.shards) == sorted(man_t.shards)
    assert "state/.s_quantity" in man_t.shards
    assert {"esc/.keys", "esc/.shares", "esc/.spent",
            "retry/.dst_w", "retry/.reserved"} <= set(man_t.shards)
    assert _npz_keys(tmp_path / "j") == _npz_keys(tmp_path / "t")
    assert (man_j.step, man_j.seq_id) == (man_t.step, man_t.seq_id) == (3, 0)
    assert os.path.exists(tmp_path / "t" / "ckpt-000000.manifest.json")


@pytest.mark.parametrize("layout,n_shards", [("sparse", 1), ("sparse", 2),
                                             ("dense", 1)])
def test_reference_run_image_restores_in_the_port(tmp_path, layout,
                                                  n_shards):
    """A run image the JAX package's ``save_run`` writes: the port's
    ``restore_run`` gives it back bit for bit, with an engine (leaves on
    its device, its escrow layout, R rings) and host-side."""
    st, esc, ring = _run_image(layout, n_shards)
    jrec.save_run(str(tmp_path), st, 4, esc=esc, retry=ring)
    te = single_host_engine(tt.TPCCScale(*SCALE), stock_invariant="strict",
                            escrow_layout=layout, device="cpu",
                            n_shards=n_shards)
    for engine in (te, None):
        rr = trec.restore_run(str(tmp_path), engine)
        assert rr.step == 4 and rr.manifest.seq_id == 0
        assert _same(st, rr.state) == []
        assert _same(esc, rr.esc) == []
        assert _same(ring, rr.retry) == []
        assert type(rr.esc).__name__ == type(esc).__name__
        assert rr.state.ol_vis.dtype == torch.bool


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_port_run_image_restores_in_the_reference(tmp_path, layout):
    """The other way: a run image the port writes restores in the
    reference's ``restore_run``, with its engine and host-side."""
    image = _run_image(layout, seed=3)
    tst, tesc, tring = _port_image(image)
    trec.save_run(str(tmp_path), tst, 6, esc=tesc, retry=tring)
    je = jengine(jt.TPCCScale(*SCALE), stock_invariant="strict",
                 escrow_layout=layout)
    for engine in (je, None):
        rr = jrec.restore_run(str(tmp_path), engine)
        assert rr.step == 6
        assert _same(rr.state, tst) == []
        assert _same(rr.esc, tesc) == []
        assert _same(rr.retry, tring) == []


def test_restore_casts_to_the_template_dtype_both_ways(tmp_path):
    """int64 stamps saved by the port restore as int32 in a reference
    template and as int64 again in the port's; int32 saved by the
    reference widens in an int64 template; bools stay bools."""
    stamps = torch.tensor([1, 2 ** 20, 7], dtype=torch.int64)
    flags = torch.tensor([True, False, True])
    man = ck.save(str(tmp_path / "t"), {"v": stamps, "f": flags}, 1)
    j_out = jck.restore(str(tmp_path / "t"), man, {
        "v": jax.ShapeDtypeStruct((3,), jnp.int32),
        "f": jax.ShapeDtypeStruct((3,), jnp.bool_)})
    assert j_out["v"].dtype == jnp.int32
    assert np.array_equal(np.asarray(j_out["v"]), stamps.numpy())
    assert j_out["f"].dtype == jnp.bool_
    t_out = ck.restore(str(tmp_path / "t"), man, {"v": stamps, "f": flags})
    assert t_out["v"].dtype == torch.int64 and torch.equal(t_out["v"], stamps)
    jman = jck.save(str(tmp_path / "j"), {"v": jnp.asarray([3, 4, 5])}, 1)
    wide = ck.restore(str(tmp_path / "j"), jman, {
        "v": torch.empty(3, dtype=torch.int64, device="meta")})
    assert wide["v"].dtype == torch.int64 and wide["v"].tolist() == [3, 4, 5]


def test_state_shape_dtypes_is_the_reference_template():
    """The port's template: the reference's shapes and dtypes at spec
    scale (allocating nothing) and ``init_state``'s at a small one."""
    spec_t = tt.state_shape_dtypes(tt.TPCCScale.spec_scale(64))
    spec_j = jt.state_shape_dtypes(jt.TPCCScale.spec_scale(64))
    for f, t, j in zip(tt.TPCCState._fields, spec_t, spec_j):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape), f
        assert str(t.dtype).split(".")[-1] == str(j.dtype), f
    small = tt.TPCCScale(*SCALE)
    real = tt.init_state(small, device="cpu")
    for f, t, r in zip(tt.TPCCState._fields, tt.state_shape_dtypes(small),
                       real):
        assert (t.shape, t.dtype) == (r.shape, r.dtype), f
