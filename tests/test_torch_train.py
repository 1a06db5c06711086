"""The training slice's pieces (``repro_torch.models.*.loss_fn``,
``optim.adamw``, ``optim.compression``, ``data.pipeline``, the training
plan, the registry's training helpers and the converters) against the JAX
package, on the CPU, at reduced size (float32) on the reference's
parameters (``convert.params_from_numpy``).

Inputs are seeded numpy draws given to both packages. Tolerances, each
stated where it is used: the losses and every gradient leaf 1e-5 (float32
end to end, the two differ in the order of float sums), remat on and off
bit-equal; AdamW 1e-6 relative; the merge 1e-6 relative (its mean of P
float32 values); the pipeline and the plans exactly.

``tests/test_torch_train_loop.py`` holds ``coord.build``, ``train.run``,
``PodSimulator`` and the launcher.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import coord as jcoord  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import adamw, compression, coord  # noqa: E402
from repro_torch.runtime import train  # noqa: E402
from repro_torch.txn import collectives  # noqa: E402

CPU = "cpu"
FAMILIES = ["smollm-360m", "olmoe-1b-7b", "rwkv6-3b", "hymba-1.5b",
            "llama-3.2-vision-11b", "whisper-tiny"]
VLM_GATES = (0.8, -0.6)         # tanh-gated cross layers, nonzero


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(cfg, jcfg, reference parameters as numpy): the reference's init
    with the vlm's cross gates and hymba's decay rates moved off their
    constant starts, so that their gradients are not hidden. Shared by
    the tests, which leave it as it is."""
    cfg = registry.get_config(arch).reduced()
    jcfg = jregistry.get_config(arch).reduced()
    tree = jax.device_get(jax.jit(lambda k: jregistry.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    if arch == "llama-3.2-vision-11b":
        tree["groups"]["cross"]["gate_attn"] = np.asarray(VLM_GATES,
                                                          np.float32)
    if arch == "hymba-1.5b":
        a = tree["layers"]["ssm"]["a_log"]
        tree["layers"]["ssm"]["a_log"] = np.random.default_rng(7).normal(
            0, 0.7, a.shape).astype(np.float32)
    return cfg, jcfg, tree


def _batch(cfg, B=2, S=16, seed=1):
    """A numpy batch of the family's inputs."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(B, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _torch(tree):
    return T.map(lambda x: torch.from_numpy(np.asarray(x)), tree)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    """Value and gradient, with a masked vocab tail (float32's min) as
    ``layers.logits`` leaves it; tolerance 1e-5."""
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(3, 5, 40)).astype(np.float32)
    lg[..., 32:] = np.finfo(np.float32).min
    labels = rng.integers(0, 32, (3, 5)).astype(np.int32)
    want, jg = jax.value_and_grad(jL.cross_entropy)(jnp.asarray(lg),
                                                    jnp.asarray(labels))
    x = torch.from_numpy(lg).requires_grad_()
    got = L.cross_entropy(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, [x])
    _close(got, want, 1e-5)
    _close(g, jg, 1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_and_gradients_match_reference(arch):
    """Each family's loss through ``registry.make_loss_fn`` and its
    gradient of every parameter leaf, against ``jax.value_and_grad`` of
    the reference's ``make_loss_fn(cfg, Rules.disabled(), remat=False)``
    (1e-5); the port's remat on and off give the same bits."""
    cfg, jcfg, tree = _params(arch)
    batch = _batch(cfg)
    want, jg = jax.jit(jax.value_and_grad(jregistry.make_loss_fn(
        jcfg, Rules.disabled(), remat=False)))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    params = L.stacked(convert.params_from_numpy(tree, cfg, CPU))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for remat in (False, True):
        runs.append(coord.value_and_grad(
            registry.make_loss_fn(cfg, remat=remat), params, tb))
    (loss, grads), (loss_r, grads_r) = runs
    _close(loss, want, 1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(T.leaves(grads)) == len(jleaves)
    for got, ref in zip(T.leaves(grads), jleaves):
        assert got.shape == ref.shape
        _close(got, ref, 1e-5)
    assert torch.equal(loss, loss_r)
    for a, b in zip(T.leaves(grads), T.leaves(grads_r)):
        assert torch.equal(a, b)


def test_losses_take_no_kernel():
    """B5 has no backward: the loss refuses its route."""
    cfg = registry.get_config("smollm-360m").reduced()
    with pytest.raises(ValueError, match="no backward"):
        registry.make_loss_fn(cfg, use_flash=True)


def test_serving_model_stays_gradient_free():
    """Training takes gradients of leaves detached from the state: the
    model a caller serves never requires a gradient."""
    cfg = registry.get_config("smollm-360m").reduced()
    model = registry.init_params(cfg, 0, CPU)
    params = L.stacked(model)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, grads = coord.value_and_grad(registry.make_loss_fn(cfg), params,
                                       batch)
    assert not any(p.requires_grad for p in model.parameters())
    assert not any(x.requires_grad for x in T.leaves(params))
    assert loss.grad_fn is None and all(g.grad_fn is None
                                        for g in T.leaves(grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_recomputes_only_under_training(arch, monkeypatch):
    """``remat`` is on by default in every ``forward``, but a serving
    prefill (no parameter or activation needs a gradient) runs each layer
    directly; a loss under autograd recomputes them
    (``torch.utils.checkpoint``)."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    cfg = registry.get_config(arch).reduced()
    model = registry.init_params(cfg, 0, CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    registry.make_prefill_fn(cfg, capacity=32)(model, batch)
    assert calls == []
    coord.value_and_grad(registry.make_loss_fn(cfg), L.stacked(model), batch)
    assert calls


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=3, total_steps=20, min_lr_frac=0.1)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(4, 6)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(5,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 2)) * scale).astype(
                      np.float32)}}


def test_lr_at_matches_reference():
    """Warmup, cosine and the floor, step by step (1e-6 relative)."""
    cfg, jcfg = adamw.AdamWConfig(**OPT), jadamw.AdamWConfig(**OPT)
    for step in range(0, 25):
        _close(adamw.lr_at(cfg, torch.tensor(step, dtype=torch.int32)),
               jadamw.lr_at(jcfg, jnp.asarray(step, jnp.int32)), 1e-6)


@pytest.mark.parametrize("mode", ["exact", "escrow", "none"])
def test_clip_grads_matches_reference(mode):
    """R = 4 replicas: the pre-clip norm and the clipped tree (1e-6
    relative), for a tree above the budget and one below it."""
    for scale in (3.0, 0.01):
        g = _tree(1, scale)
        kw = dict(clip_norm=1.0, clip_mode=mode, num_replicas=4)
        got, norm = adamw.clip_grads(_torch(g), adamw.AdamWConfig(**kw))
        want, jnorm = jadamw.clip_grads(jax.tree.map(jnp.asarray, g),
                                        jadamw.AdamWConfig(**kw))
        _close(norm, jnorm, 1e-6)
        _close(adamw.global_norm(_torch(g)),
               jadamw.global_norm(jax.tree.map(jnp.asarray, g)), 1e-6)
        for a, b in zip(T.leaves(got), jax.tree_util.tree_leaves(want)):
            _close(a, b, 1e-6)


def test_escrow_clip_bounds_global_norm():
    """R local clips at tau/sqrt(R) bound the global norm by tau."""
    cfg = adamw.AdamWConfig(clip_norm=1.0, clip_mode="escrow",
                            num_replicas=4)
    rng = np.random.default_rng(0)
    shards = [{"w": torch.from_numpy(rng.normal(0, 5, (16,)))}
              for _ in range(4)]
    clipped = [adamw.clip_grads(s, cfg)[0] for s in shards]
    total = sum(float(adamw.global_norm(c)) ** 2 for c in clipped)
    assert np.sqrt(total) <= 1.0 + 1e-5


def test_update_matches_reference():
    """Three AdamW steps from zero moments, escrow clipping at R = 2: the
    parameters, both moments, the count and the metrics (1e-6
    relative)."""
    kw = dict(OPT, clip_mode="escrow", num_replicas=2, weight_decay=0.1)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    p, jp = _torch(_tree(2)), jax.tree.map(jnp.asarray, _tree(2))
    st, jst = adamw.init(p), jadamw.init(jp)
    for t in range(3):
        g = _tree(10 + t, scale=2.0)
        p, st, m = adamw.update(cfg, _torch(g), st, p)
        jp, jst, jm = jadamw.update(jcfg, jax.tree.map(jnp.asarray, g),
                                    jst, jp)
        for key in ("grad_norm", "lr"):
            _close(m[key], jm[key], 1e-6)
    assert int(st.count) == int(jst.count) == 3
    assert st.count.dtype == torch.int32
    for got, want in ((p, jp), (st.mu, jst.mu), (st.nu, jst.nu)):
        for a, b in zip(T.leaves(got), jax.tree_util.tree_leaves(want)):
            _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# the compressed merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
@pytest.mark.parametrize("pods", [2, 4])
def test_merge_mean_matches_reference(compress, pods):
    """Every leaf [P, ...] merged over its pods against the reference's
    ``merge_mean`` under ``jax.vmap`` with the ``pod`` axis name (1e-6
    relative); every pod holds the same mean; the wire: none one
    all-reduce of N float32 a leaf, bf16 an all-gather of P N bf16, int8
    a scalar pmax (an all-reduce of 4 bytes) and an all-gather of P N
    int8."""
    rng = np.random.default_rng(pods)
    tree = {"w": rng.normal(size=(pods, 7, 5)).astype(np.float32),
            "v": {"b": (rng.normal(size=(pods, 33)) * 1e-3).astype(
                np.float32)}}
    want = jax.vmap(lambda t: jcomp.merge_mean(t, "pod", pods, compress),
                    axis_name="pod")(jax.tree.map(jnp.asarray, tree))
    with collectives.counted() as stats:
        got = compression.merge_mean(_torch(tree), compress)
    for a, b in zip(T.leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a, b, 1e-6)
        assert all(torch.equal(a[0], a[i]) for i in range(pods))
    n = [x[0].size for x in T.leaves(tree)]
    if compress == "none":
        assert dict(stats.counts) == {"all-reduce": 2}
        assert stats.bytes["all-reduce"] == 4 * sum(n)
    else:
        width = 2 if compress == "bf16" else 1
        assert stats.counts["all-gather"] == 2
        assert stats.bytes["all-gather"] == width * pods * sum(n)
        assert stats.counts["all-reduce"] == (2 if compress == "int8"
                                              else 0)
        assert stats.bytes["all-reduce"] == (8 if compress == "int8" else 0)
    with pytest.raises(ValueError, match="unknown compression"):
        compression.merge_mean(_torch(tree), "fp4")


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pipeline_batches_equal_reference(n_shards):
    """Three batches of tokens and labels, bit-equal, int32."""
    cfg = registry.get_config("smollm-360m").reduced()
    jcfg = jregistry.get_config("smollm-360m").reduced()
    dc = dict(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=3,
              n_shards=n_shards)
    p = pipeline.Pipeline(pipeline.DataConfig(**dc), cfg)
    jp = jpipe.Pipeline(jpipe.DataConfig(**dc), jcfg)
    for _ in range(3):
        got, want = p.next_batch(), jp.next_batch()
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert p.sample_ids_seen() == jp.sample_ids_seen()
    assert len(p.sample_ids_seen()) == 24
    assert p.state() == jp.state()


def test_pipeline_bookkeeping_matches_reference():
    """The cursor's max-join, ``state`` and a max-join ``restore`` (a
    replayed older snapshot moves nothing)."""
    a, b = pipeline.ShardCursor(0, 2, cursor=5), pipeline.ShardCursor(
        0, 2, cursor=9)
    ja, jb = jpipe.ShardCursor(0, 2, cursor=5), jpipe.ShardCursor(
        0, 2, cursor=9)
    assert pipeline.ShardCursor.join(a, b).cursor == \
        jpipe.ShardCursor.join(ja, jb).cursor == 9
    np.testing.assert_array_equal(a.next_ids(3), ja.next_ids(3))
    cfg = registry.get_config("smollm-360m").reduced()
    dc = dict(vocab=cfg.vocab, seq_len=8, global_batch=4, n_shards=2)
    p = pipeline.Pipeline(pipeline.DataConfig(**dc), cfg)
    jp = jpipe.Pipeline(jpipe.DataConfig(**dc),
                        jregistry.get_config("smollm-360m").reduced())
    snap = {"cursors": [6, 4], "n_shards": 2}
    for x in (p, jp):
        x.restore(snap)
        x.restore({"cursors": [1, 1], "n_shards": 2})
    assert p.state() == jp.state() == snap
    np.testing.assert_array_equal(p.next_batch()["tokens"].numpy(),
                                  np.asarray(jp.next_batch()["tokens"]))
    assert p.sample_ids_seen() == jp.sample_ids_seen()
    with pytest.raises(ValueError, match="divide"):
        pipeline.Pipeline(pipeline.DataConfig(cfg.vocab, 8, 5, n_shards=2),
                          cfg)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_stub_embeds_raise_as_reference(arch):
    """The stub frontend seeds numpy with a string, which it refuses: the
    reference cannot draw a vlm or audio batch from its pipeline, and
    neither can the port."""
    cfg = registry.get_config(arch).reduced()
    dc = dict(vocab=cfg.vocab, seq_len=8, global_batch=2)
    errors = []
    for mod, c in ((pipeline, cfg), (jpipe,
                                     jregistry.get_config(arch).reduced())):
        with pytest.raises(ValueError) as e:
            mod.Pipeline(mod.DataConfig(**dc), c).next_batch()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "unrecognized seed string"


# ---------------------------------------------------------------------------
# the training plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "hierarchical", "local_sgd"])
@pytest.mark.parametrize("exact_clip", [False, True])
def test_training_plan_matches_reference(mode, exact_clip):
    """``training_state_specs``, ``coordination_plan(...).summary()`` and
    ``validate_plan`` (the same refusal, word for word) in every mode."""
    kw = dict(coord_mode=mode, merge_every=4, exact_clip=exact_clip)
    specs = planner.training_state_specs(**kw)
    jspecs = jplanner.training_state_specs(**kw)
    assert [(s.name, s.lattice, s.merge_every, s.note) for s in specs] == \
        [(s.name, s.lattice, s.merge_every, s.note) for s in jspecs]
    clip = "exact" if exact_clip else "escrow"
    tc = train.TrainConfig(coord=coord.CoordConfig(mode=mode, merge_every=4),
                           opt=adamw.AdamWConfig(clip_mode=clip))
    jtc = jtrain.TrainConfig(
        coord=jcoord.CoordConfig(mode=mode, merge_every=4),
        opt=jadamw.AdamWConfig(clip_mode=clip))
    plan, jplan = train.coordination_plan(tc), jtrain.coordination_plan(jtc)
    assert plan.summary() == jplan.summary()
    assert [(e.spec.name, e.coord_class.value, e.strategy.value)
            for e in plan.entries] == \
        [(e.spec.name, e.coord_class.value, e.strategy.value)
         for e in jplan.entries]
    outcomes = []
    for fn, cfg in ((train.validate_plan, tc), (jtrain.validate_plan, jtc)):
        try:
            fn(cfg)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == (exact_clip and mode != "sync")


# ---------------------------------------------------------------------------
# the registry and the converters
# ---------------------------------------------------------------------------


def test_registry_counts_and_specs_match_reference():
    """Exact and active parameter counts of all ten archs at full size
    (from meta tensors) and their training input specs at the reference's
    ``train_4k`` shape."""
    from repro_torch.models.config import SHAPES
    from repro.models.config import SHAPES as JSHAPES
    for arch in registry.ARCHS:
        cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
        assert registry.exact_param_count(cfg) == \
            jregistry.exact_param_count(jcfg), arch
        assert registry.exact_active_param_count(cfg) == \
            jregistry.exact_active_param_count(jcfg), arch
        specs = registry.train_input_specs(cfg, SHAPES["train_4k"])
        jspecs = jregistry.train_input_specs(jcfg, JSHAPES["train_4k"])
        assert sorted(specs) == sorted(jspecs)
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == jspecs[k].shape
            assert str(v.dtype).split(".")[-1] == str(jspecs[k].dtype)
    tree = registry.abstract_params(registry.get_config("olmoe-1b-7b"))
    assert all(x.device.type == "meta" for x in T.leaves(tree))


@pytest.mark.parametrize("arch", ["smollm-360m", "llama-3.2-vision-11b",
                                  "whisper-tiny"])
def test_make_train_batch(arch):
    """Shapes and dtypes of the reference's batch, values in range, and
    the same draws from the same seed."""
    cfg = registry.get_config(arch).reduced()
    jcfg = jregistry.get_config(arch).reduced()
    want = jregistry.make_train_batch(jax.random.PRNGKey(0), jcfg, 3, 7)
    draw = lambda: registry.make_train_batch(
        torch.Generator().manual_seed(4), cfg, 3, 7)
    got, again = draw(), draw()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype)
        assert torch.equal(v, again[k])
    assert 0 <= int(got["tokens"].min()) and int(got["labels"].max()) < \
        cfg.vocab


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_round_trip(arch):
    """``params_to_numpy`` inverts ``params_from_numpy`` (every leaf, bit
    for bit, the reference's tree structure), and ``layers.stacked`` of
    the model is the tree ``layers.bind`` reads back."""
    cfg, _, tree = _params(arch)
    model = convert.params_from_numpy(tree, cfg, CPU)
    back = convert.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    bound = L.bind(L.stacked(model))
    for name, p in model.named_parameters():
        node = bound
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else getattr(node, part)
        assert torch.equal(node, p), name


@pytest.mark.parametrize("pods", [1, 2])
def test_train_state_round_trip(pods):
    """``train_state_to_numpy`` / ``train_state_from_numpy`` carry a whole
    ``TrainState``, moments and the pod dim included, in the reference's
    structure, bit for bit."""
    cfg = registry.get_config("hymba-1.5b").reduced()
    mode = "sync" if pods == 1 else "hierarchical"
    setup = coord.build(cfg, coord.CoordConfig(mode=mode),
                        adamw.AdamWConfig(), registry.make_loss_fn,
                        n_pods=pods, device=CPU)
    state = setup.init_fn(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B=2).items()}
    state = setup.step_fn(state, batch)
    host = convert.train_state_to_numpy(state)
    assert isinstance(host, coord.TrainState)
    lead = (pods, cfg.n_layers) if pods > 1 else (cfg.n_layers,)
    assert host.params["layers"]["attn"]["wq"].shape[:len(lead)] == lead
    back = convert.train_state_from_numpy(host, CPU)
    for a, b in zip(T.leaves(back), T.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jstate = jcoord.TrainState(
        host.params, jadamw.AdamWState(*host.opt), *host[2:])
    assert len(jax.tree_util.tree_leaves(jstate)) == len(T.leaves(state))
