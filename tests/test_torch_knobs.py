"""The port's one-card training knobs on the CPU: ``prefetch_carry="remat"``,
``carry_offload="host"``, ``offload_opt=True`` and ``clip_mode="approx"``.

* Against the JAX package's ``build_train_step`` with the same knob: smoke
  llama3.2-1b, fp32 gather, 3 steps from the same state, within
  ``test_torch_train.TOL["fp32"]`` (approx with a clip that binds at every
  step).
* Within the port, bitwise: each carry and the host moments against the
  default, the approximate clip with the clip inactive against the exact
  clip at three bucket sizes and with zero gradients; smoke llama and the
  smoke griffin (6 layers: ``g`` x2, so the carries, which take pools of
  more than one layer, engage), both wires.
* The approximate clip binding: step 1 as the exact clip's, the loss falls,
  the final loss of a short run within ``APPROX_CLIP_LOSS_RTOL`` of it.
* ``core/hostoffload.HostStash``: the carry slots drain after every
  micro-step and are reused, host moments persist across steps; checkpoints
  with host moments resume bitwise and restore across ``offload_opt``.
* Over ranks: one 4-rank gloo world (``torch_dist_harness.py knobs``), the
  port against itself: remat at layout A, approx at layout B, the host carry
  and moments at layout B, bitwise, with the collective counts.
* ``gpu``: the stash's pinned slots and the knobs' steps on the card."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core import hostoffload as jax_stash  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.core.mics import build_train_step as jax_train_step  # noqa: E402
from repro.core.mics import init_state as jax_init_state  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import OptConfig as JaxOptConfig  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.core import hostoffload  # noqa: E402
from repro_torch.core.comm import CommEngine  # noqa: E402
from repro_torch.core.mics import MiCSConfig, build_train_step, init_state  # noqa: E402
from repro_torch.core.schedule import APPROX_CLIP_LOSS_RTOL, plan_boundary  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from test_torch_train import TOL  # noqa: E402

MICRO, BATCH, SEQ, STEPS = 2, 2, 64, 3
OPT = dict(warmup_steps=0, total_steps=10, lr_max=1e-3)
PARTS = ("params", "m", "v")
WIRES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# Grad norms of these runs are 7.4-31 (llama 7.4-9.4): a clip_norm of 0.5
# binds at every step, 1e9 never.
CLIP_BINDS, CLIP_NEVER = 0.5, 1e9

# knob -> (MiCSConfig keywords, OptConfig keywords), the same on both sides
JAX_KNOBS = {
    "remat": ({"prefetch_carry": "remat"}, {}),
    "carry_host": ({"carry_offload": "host"}, {}),
    "carry_host+offload_opt": ({"carry_offload": "host", "offload_opt": True}, {}),
    "approx": ({"clip_mode": "approx"}, {"clip_norm": CLIP_BINDS}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke steps run as fast on one thread, and the test workers and
    the gloo ranks beside them do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(vocab, steps=STEPS, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    shape = (MICRO, BATCH, SEQ)
    return [{"tokens": rng.integers(0, vocab, shape).astype(np.int32),
             "targets": rng.integers(0, vocab, shape).astype(np.int32),
             "mask": ((rng.uniform(size=shape) < 0.9) if masked
                      else np.ones(shape)).astype(np.float32)} for _ in range(steps)]


def _equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[part][k], b[part][k]) for part in PARTS for k in a[part])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_setup(topo1):
    cfg_j = jax_smoke(jax_get_config("llama3.2-1b"))
    model_j = jax_build_model(cfg_j, tp=1)
    state0 = jax_init_state(model_j, topo1, seed=0)
    init = {part: {k: np.asarray(v) for k, v in state0[part].items()} for part in PARTS}
    init["step"] = 0
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    return model, model_j, init, _batches(cfg_j.vocab)


def _jax_run(model_j, topo1, init, batches, kw, opt):
    """The reference's 3 steps with the knob; with ``offload_opt`` its m and
    v come out of its host stash (slot = pool index)."""
    offload = kw.get("offload_opt", False)
    step = jax_train_step(model_j, topo1, JaxMiCSConfig(micro_steps=MICRO,
                                                        gather_dtype=jnp.float32, **kw),
                          JaxOptConfig(**OPT, **opt))
    state = {"params": {k: jnp.asarray(v) for k, v in init["params"].items()},
             "step": jnp.int32(0)}
    if not offload:
        state.update({part: {k: jnp.asarray(v) for k, v in init[part].items()}
                      for part in ("m", "v")})
    jax_stash.stash_clear()
    try:
        metrics = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out = {part: {k: np.asarray(v) for k, v in state[part].items()}
               for part in PARTS if part in state}
        if offload:
            entries = jax_stash.export_stash()
            for part, tag in (("m", jax_stash.TAG_M), ("v", jax_stash.TAG_V)):
                out[part] = {pool.name: next(v for k, v in entries.items()
                                             if k[1:3] == (tag, i)).reshape(
                                                 init["params"][pool.name].shape)
                             for i, pool in enumerate(model_j.all_pools())}
    finally:
        jax_stash.stash_clear()
    return metrics, out


@pytest.mark.parametrize("knob", list(JAX_KNOBS))
def test_knob_matches_jax(jax_setup, topo1, knob):
    """The port with a knob against the reference with the same knob, fp32
    gather, 3 steps: losses, grad norms and the final params, m and v within
    the default step's tolerances."""
    kw, opt = JAX_KNOBS[knob]
    model, model_j, init, batches = jax_setup
    want_metrics, want = _jax_run(model_j, topo1, init, batches, kw, opt)
    state = state_from_jax(model, init, device="cpu")
    step = build_train_step(model, MiCSTopology(), MiCSConfig(
        micro_steps=MICRO, gather_dtype=torch.float32, **kw), OptConfig(**OPT, **opt),
        device="cpu")
    tol = TOL["fp32"]
    for i, (b, (jloss, jgn)) in enumerate(zip(batches, want_metrics)):
        state, m = step(state, b)
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        assert abs(loss - jloss) <= tol["loss"] * abs(jloss), (i, loss, jloss)
        assert abs(gn - jgn) <= tol["grad_norm"] * abs(jgn), (i, gn, jgn)
        if "clip_norm" in opt:
            assert gn > opt["clip_norm"] and jgn > opt["clip_norm"]   # the clip binds
    for part in PARTS:
        for name, w in want[part].items():
            err = float(np.abs(state[part][name].numpy() - w).max())
            bound = tol[part] if part == "params" else tol[part] * float(np.abs(w).max())
            assert err <= bound, f"{knob} {part}[{name}]: max |err| {err} > {bound}"


# ---------------------------------------------------------------------------
# within the port, bitwise
# ---------------------------------------------------------------------------

ARCHS = {"llama": "llama3.2-1b", "griffin": "recurrentgemma-2b"}
BITWISE = {"remat": {"prefetch_carry": "remat"}, "carry_host": {"carry_offload": "host"},
           "offload_opt": {"offload_opt": True}}
# 0.01 MB cuts every pool into many buckets, some across rows; 1000 MB is
# one bucket a pool
APPROX_BUCKETS = (0.01, 0.25, 1000.0)


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, arch in ARCHS.items():
        model = build_model(smoke_variant(get_config(arch)), tp=1)
        assert max(p.stack for p in model.pools) >= 2
        out[key] = model
    return out


def _port(model, wire, steps=STEPS, *, opt=None, batches=None, state=None, **kw):
    """``steps`` steps of the port from the seeded init (or ``state``):
    ``(metrics, state, step_fn)``, the metrics a list of (loss, grad_norm)."""
    mc = MiCSConfig(micro_steps=MICRO, gather_dtype=WIRES[wire], **kw)
    if state is None:
        state = init_state(model, 0, device="cpu", offload_opt=mc.offload_opt)
    step = build_train_step(model, MiCSTopology(), mc, OptConfig(**OPT, **(opt or {})),
                            device="cpu")
    metrics = []
    for b in batches or _batches(model.cfg.vocab, steps, masked=True):
        state, m = step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, state, step


@pytest.fixture(scope="module")
def defaults(models):
    """The default step's runs, per (model, wire)."""
    return {(key, wire): _port(model, wire)[:2] for key, model in models.items()
            for wire in WIRES}


@pytest.mark.parametrize("knob", list(BITWISE))
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_knob_is_bitwise_the_default(models, defaults, arch, wire, knob):
    """The remat carry, the host carry and the host moments change where
    data lives, not one operation: 3 steps give bitwise the default's
    losses, grad norms, params, m and v."""
    metrics, state, step = _port(models[arch], wire, **BITWISE[knob])
    want_metrics, want = defaults[(arch, wire)]
    assert metrics == want_metrics
    assert _equal(state, want)
    snap = step.comm.host_stash.snapshot()
    moved = snap["bytes_down"] > 0 and snap["bytes_up"] == snap["bytes_down"]
    assert moved == (knob != "remat")
    assert snap["live_slots"] == 0


@pytest.mark.parametrize("bucket_mb", APPROX_BUCKETS)
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_approx_with_inactive_clip_is_bitwise_exact(models, arch, wire, bucket_mb):
    """With the clip inactive every prefix factor is exactly 1: the
    approximate pipeline runs the exact clip's elementwise update, bucket by
    bucket (a bucket across two rows split at the row's edge), and reports
    the exact fold's grad norm."""
    model = models[arch]
    plan = plan_boundary(model, MiCSTopology(), mode="bucketed", bucket_mb=bucket_mb)
    shards = {p.name: p.layout.flat_len for p in model.all_pools()}
    crossing = sum(b.lo // shards[b.pool] != (b.hi - 1) // shards[b.pool] for b in plan.buckets)
    assert crossing
    if bucket_mb == 1000.0:
        assert set(plan.describe()["buckets_per_pool"].values()) == {1}
    runs = [_port(model, wire, opt={"clip_norm": CLIP_NEVER}, hop2_bucket_mb=bucket_mb,
                  clip_mode=clip)[:2] for clip in ("exact", "approx")]
    assert runs[0][0] == runs[1][0]
    assert _equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_approx_with_zero_gradients(models, arch, wire):
    """Every token masked out: zero gradients, a zero norm; the clip factor
    of a zero prefix is 1, so the approximate step is finite and bitwise the
    exact one."""
    model = models[arch]
    batches = [{**b, "mask": np.zeros_like(b["mask"])} for b in _batches(model.cfg.vocab)]
    runs = [_port(model, wire, batches=batches, hop2_bucket_mb=0.01, clip_mode=clip)[:2]
            for clip in ("exact", "approx")]
    assert all(gn == 0.0 and np.isfinite(loss) for loss, gn in runs[1][0])
    assert all(torch.isfinite(t).all() for part in PARTS for t in runs[1][1][part].values())
    assert runs[0][0] == runs[1][0]
    assert _equal(runs[0][1], runs[1][1])


def test_approx_with_binding_clip_converges_as_exact(models):
    """The clip binds at every step: step 1's loss and grad norm are the
    exact clip's (the reported norm is the exact fold), the loss falls over a
    short run on two repeated batches, and its final loss is within
    ``APPROX_CLIP_LOSS_RTOL`` of the exact clip's."""
    model = models["llama"]
    two = _batches(model.cfg.vocab, 2, seed=5)
    batches = [two[i % 2] for i in range(8)]
    runs = {clip: _port(model, "bf16", opt={"clip_norm": CLIP_BINDS}, batches=batches,
                        hop2_bucket_mb=0.01, clip_mode=clip)[0]
            for clip in ("exact", "approx")}
    exact, approx = runs["exact"], runs["approx"]
    assert all(gn > CLIP_BINDS for _, gn in exact + approx)
    assert approx[0] == exact[0] and approx[1:] != exact[1:]
    assert approx[-1][0] < approx[0][0] - 0.05
    assert abs(approx[-1][0] - exact[-1][0]) <= APPROX_CLIP_LOSS_RTOL * exact[-1][0]


# ---------------------------------------------------------------------------
# the host stash
# ---------------------------------------------------------------------------

def test_carry_slots_drain_every_micro_step(models):
    """Each micro-step's forward fills one slot a layer of the pools of more
    than one layer, its backward empties every one; the slots are allocated
    once and reused."""
    model = models["griffin"]
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(carry_offload="host"))
    ctx = L.Ctx(mode="train", compute_dtype=torch.bfloat16)
    params = init_state(model, 0, device="cpu")["params"]
    rows = {k: [p[i, 0].detach().requires_grad_(True) for i in range(p.shape[0])]
            for k, p in params.items()}
    stash, ptrs = comm.host_stash, None
    carried = sum(p.stack for p in model.pools if p.stack > 1)
    for b in _batches(model.cfg.vocab, 2):
        for mb in range(MICRO):
            micro = {k: torch.as_tensor(v[mb]) for k, v in b.items()}
            loss, _ = lm.loss_fn(model, rows, comm, ctx, micro)
            assert stash.live_slots() == carried
            loss.backward()
            assert stash.live_slots() == 0
            now = sorted(t.data_ptr() for t in stash._slots.values())
            assert ptrs is None or now == ptrs
            ptrs = now
    assert stash.snapshot()["slots"] == carried
    # a forward whose graph is dropped without a backward frees its slots
    loss, metrics = lm.loss_fn(model, rows, comm, ctx, micro)
    assert stash.live_slots() == carried
    del loss, metrics
    assert stash.live_slots() == 0


def test_stash_refuses_a_held_slot_and_a_second_fetch():
    stash = hostoffload.HostStash()
    x = torch.arange(6, dtype=torch.bfloat16)
    h = stash.put(("p", 0), x)
    with pytest.raises(RuntimeError, match="still holds"):
        stash.put(("p", 0), x)
    assert torch.equal(stash.get(h), x)
    with pytest.raises(RuntimeError, match="fetched already"):
        stash.get(h)
    with pytest.raises(ValueError, match="carry slot"):
        stash.put(("p", 0), torch.zeros(5, dtype=torch.bfloat16))
    assert stash.snapshot() == {"bytes_down": 12, "bytes_up": 12, "live_slots": 0,
                                "slots": 1, "slot_bytes": 12}


def test_host_moments_persist_across_steps(models):
    """With ``offload_opt`` the state's m and v are host tensors that the
    boundary updates in place: the same storage step after step, moved a
    slice at a time both ways."""
    model = models["llama"]
    _, state, step = _port(model, "bf16", steps=1, offload_opt=True)
    ptrs = {k: t.data_ptr() for k, t in state["m"].items()}
    before = {k: t.clone() for k, t in state["m"].items()}
    assert all(t.device.type == "cpu" for part in ("m", "v") for t in state[part].values())
    assert all(t.abs().amax() > 0 for t in before.values())
    state, _ = step(state, _batches(model.cfg.vocab, 1, seed=3)[0])
    assert {k: t.data_ptr() for k, t in state["m"].items()} == ptrs
    assert all(not torch.equal(state["m"][k], before[k]) for k in before)
    moments = sum(t.numel() * 4 for t in state["m"].values()) * 2
    assert step.comm.host_stash.snapshot()["bytes_up"] == 2 * moments


def _save(state, step_n, path):
    Checkpointer(path).save(state, step_n, topo=MiCSTopology(), data_cursor=step_n)


def test_host_moments_checkpoint_resume_bitwise(models, tmp_path):
    """2 steps, save, restore with ``offload_opt``, 1 step: bitwise 3
    straight steps."""
    model = models["llama"]
    batches = _batches(model.cfg.vocab)
    whole = _port(model, "bf16", batches=batches, offload_opt=True)
    first = _port(model, "bf16", batches=batches[:2], offload_opt=True)
    _save(first[1], 2, tmp_path)
    state, meta = Checkpointer(tmp_path).restore(model, device="cpu", offload_opt=True)
    rest = _port(model, "bf16", batches=batches[2:], state=state, offload_opt=True)
    assert meta["step"] == 2 and first[0] + rest[0] == whole[0]
    assert _equal(rest[1], whole[1])


@pytest.mark.parametrize("saved_on", [True, False])
def test_checkpoint_restores_across_offload_opt(models, tmp_path, saved_on):
    """A checkpoint holds the same files either way: saved with the moments
    in host memory (or on the device), it restores with them on the device
    (or in host memory) to the same bits, and the next step agrees."""
    model = models["llama"]
    batches = _batches(model.cfg.vocab)
    saved = _port(model, "bf16", batches=batches[:2], offload_opt=saved_on)[1]
    _save(saved, 2, tmp_path)
    runs = []
    for offload in (saved_on, not saved_on):
        state, _ = Checkpointer(tmp_path).restore(model, device="cpu", offload_opt=offload)
        assert _equal(state, saved)
        runs.append(_port(model, "bf16", batches=batches[2:], state=state,
                          offload_opt=offload)[:2])
    assert runs[0][0] == runs[1][0] and _equal(runs[0][1], runs[1][1])


# ---------------------------------------------------------------------------
# over ranks: one 4-rank gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("knobs")
    K.finish(K.start("torch_dist_harness.py", "knobs", str(out)), 300)
    return K.load_ranks(str(out / "port_knobs.rank{r}.npz"))


def _same_runs(got: dict, a: str, b: str) -> None:
    keys = [k for k in got if k.startswith(a + ".") and not k.endswith(".calls")]
    assert len(keys) == 1 + 3 * 3    # metrics, params / m / v of 3 pools
    for k in keys:
        assert np.array_equal(got[k], got[k.replace(a, b, 1)]), k


def _calls(got: dict, run: str, rank: int) -> dict:
    return json.loads(str(got[f"{run}.calls"][rank]))


def test_remat_over_ranks(ranks):
    """Layout A (p 4, ``outer_first``): remat is bitwise the stored carry, and
    re-gathers each row of a pool of more than one layer once more a
    micro-step, at each stage of the staged gather."""
    _same_runs(ranks, "A.remat", "A.stored")
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    extra = sum(p.stack for p in model.pools if p.stack > 1) * K.MICRO * K.STEPS
    for r in range(K.WORLD):
        stored, remat = _calls(ranks, "A.stored", r), _calls(ranks, "A.remat", r)
        assert {k: remat[k] - stored[k] for k in stored} == {
            k: extra if k.startswith("all_gather:") else 0 for k in stored}


def test_approx_over_ranks(ranks):
    """Layout B (p 2 x 2 replicas), many buckets, the clip inactive: the
    approximate clip is bitwise the exact one and sums each bucket's norm
    partial over the partition group, plus the reported norm's once, a
    step."""
    _same_runs(ranks, "B.approx", "B.exact")
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    topo = MiCSTopology(**K.topo_kwargs("B"))
    n = plan_boundary(model, topo, mode="bucketed", bucket_mb=K.KNOB_BUCKET_MB).n_buckets
    for r in range(K.WORLD):
        exact, approx = _calls(ranks, "B.exact", r), _calls(ranks, "B.approx", r)
        assert exact["all_reduce:partition"] == K.STEPS
        assert approx["all_reduce:partition"] == (n + 1) * K.STEPS
        assert approx["all_reduce:replication"] == exact["all_reduce:replication"] == \
            n * K.STEPS


def test_host_knobs_over_ranks(ranks):
    """Layout B with the host carry and host moments: bitwise the default,
    the same collectives."""
    _same_runs(ranks, "B.host", "B.default")
    for r in range(K.WORLD):
        assert _calls(ranks, "B.host", r) == _calls(ranks, "B.default", r)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_stash_and_knobs(models):
    """Pinned slots of exactly their bytes, released with their tensors; a
    carry round trip through the copy stream; 2 steps of the smoke llama on
    the card with each knob bitwise the default there (approx with the clip
    inactive against the exact clip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy stream and pinned memory")
    base = hostoffload.pinned_bytes()
    t = hostoffload.pinned_zeros((3, 1000), torch.float32, "cuda")
    assert t.is_pinned() and hostoffload.pinned_bytes() - base == 12000
    del t
    assert hostoffload.pinned_bytes() == base
    stash = hostoffload.HostStash()
    x = torch.randn(1 << 20, device="cuda").to(torch.bfloat16)
    assert torch.equal(stash.get(stash.put(("p", 0), x)), x)

    model = models["llama"]

    def run(**kw):
        mc = MiCSConfig(micro_steps=MICRO, **kw)
        state = init_state(model, 0, device="cuda", offload_opt=mc.offload_opt)
        step = build_train_step(model, MiCSTopology(), mc,
                                OptConfig(**OPT, clip_norm=CLIP_NEVER), device="cuda")
        out = []
        for b in _batches(model.cfg.vocab, 2, masked=True):
            state, m = step(state, b)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        return out, {part: {k: v.cpu() for k, v in state[part].items()} for part in PARTS}

    default = run()
    for kw in (*BITWISE.values(), {"clip_mode": "approx"}):
        got = run(**kw)
        assert got[0] == default[0] and _equal(got[1], default[1]), kw
