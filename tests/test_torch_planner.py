"""The port's link model, memory planner and autotuner (``core/linkmodel.py``,
``core/memplan.py``, ``core/autotune.py``) against the JAX package's, on the
CPU: pure arithmetic, so every registered config prices at full size.

* the link model's α-β algebra equal to the reference's on the same fields
  (its ``v5e`` table carried over field by field);
* every memory term the port prices as the reference does equal to it over
  a grid of configs, partition sizes, replicas, wires, carries,
  ``offload_opt`` and train / serve with KV pages; each term the port
  prices differently (``core/memplan``'s docstring) by its stated rule;
  the plan's state bytes exactly the tensors ``init_state`` makes;
* the decision rules (``min_partition_size``, ``resolve_scale``,
  ``rank_policies``, ``resolve_config``, ``resolve_world``,
  ``rerank_serve_world``) the reference's: with the reference's collective
  event counts swapped in, ``predict_traffic`` and the whole ranking are
  the reference's to the bit; with the port's own (its eager schedule's:
  no wrap-around lookahead, nothing hoisted out of the micro-step loop)
  the per-event bytes are the reference's and the choice too;
* the launchers under ``--policy auto``.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import autotune as RA  # noqa: E402
from repro.core import linkmodel as RL  # noqa: E402
from repro.core import memplan as RM  # noqa: E402
from repro.core.comm import GatherPolicy as RGather  # noqa: E402
from repro.core.comm import SyncPolicy as RSync  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, smoke_variant  # noqa: E402
from repro_torch.core import autotune as A  # noqa: E402
from repro_torch.core import linkmodel as LM  # noqa: E402
from repro_torch.core import memplan as M  # noqa: E402
from repro_torch.core.comm import CommEngine, GatherPolicy, SyncPolicy  # noqa: E402
from repro_torch.core.comm import policies_from_config  # noqa: E402
from repro_torch.core.mics import MiCSConfig, init_state  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402

CONFIGS = sorted(REGISTRY)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _link(link):
    return LM.Link(bandwidth=link.bandwidth, alpha=link.alpha)


def v5e() -> LM.LinkProfile:
    """The reference's TPU table, carried over field by field (the port
    states no TPU figure of its own)."""
    r = RL.V5E
    return LM.LinkProfile(name=r.name, intra=_link(r.intra), inter=_link(r.inter),
                          node_size=r.node_size, local_copy_bw=r.local_copy_bw,
                          peak_flops=r.peak_flops, hbm_bw=r.hbm_bw, hbm_bytes=r.hbm_bytes,
                          description=r.description, host=_link(r.host))


PROFILES = {"v5e": (v5e, lambda: RL.V5E), "efa-100g": (lambda: LM.EFA_100G, lambda: RL.EFA_100G),
            "efa-400g": (lambda: LM.EFA_400G, lambda: RL.EFA_400G)}


def _models(name: str, tp: int = 1):
    return build_model(get_config(name), tp=tp), jax_build_model(jax_get_config(name), tp=tp)


def _close(a: float, b: float) -> bool:
    return a == pytest.approx(b, rel=1e-12, abs=1e-9)


# ---------------------------------------------------------------------------
# the link model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PROFILES))
def test_link_model_is_the_reference(name):
    port, ref = (f() for f in PROFILES[name])
    for tier in ("intra", "inter", "host"):
        for g in (1, 2, 3, 8, 16):
            for nbytes in (0.0, 1.0, 1e6, 3.3e9):
                assert port.ring_time(tier, g, nbytes) == ref.ring_time(tier, g, nbytes)
        for nbytes, events in ((0.0, 0), (1e6, 1), (2.5e9, 7)):
            assert port.xfer_time(tier, nbytes, events) == ref.xfer_time(tier, nbytes, events)
    for nbytes in (0.0, 1e6, 7.7e9):
        assert port.hbm_time(nbytes) == ref.hbm_time(nbytes)
        assert port.copy_time(nbytes) == ref.copy_time(nbytes)
    for positions in ((0, 1), (0, 7), (0, 8), (3, 12, 21)):
        assert port.group_tier(positions) == ref.group_tier(positions)
    assert LM.get_profile(port) is port
    for gb in (100, 400, 3200):
        assert LM.gbps(gb) == RL.gbps(gb)


def test_custom_profile_and_the_card_default():
    """``custom_profile`` equal to the reference's for the same fields; its
    defaults, and ``MiCSConfig.link_profile``'s, are the card's profile;
    ``v5e`` is not carried."""
    kw = dict(intra_bw=100e9, inter_bw=LM.gbps(200), node_size=4, alpha_intra=2e-6,
              alpha_inter=20e-6, host_bw=30e9, alpha_host=4e-6, local_copy_bw=1e12,
              peak_flops=5e14, hbm_bw=2e12, hbm_bytes=48 * LM.GIB)
    port, ref = LM.custom_profile("c", **kw), RL.custom_profile("c", **kw)
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name) or f.name in ("intra", "inter",
                                                                             "host")
    for tier in ("intra", "inter", "host"):
        assert port.link(tier).bandwidth == ref.link(tier).bandwidth
        assert port.link(tier).alpha == ref.link(tier).alpha
    card = LM.get_profile(LM.DEFAULT_PROFILE)
    assert MiCSConfig().link_profile == card.name == "h100-p5"
    d = LM.custom_profile("d", intra_bw=1e9, inter_bw=1e9, node_size=2)
    assert (d.peak_flops, d.hbm_bw, d.hbm_bytes, d.local_copy_bw) == (
        card.peak_flops, card.hbm_bw, card.hbm_bytes, card.local_copy_bw)
    assert (d.intra.alpha, d.inter.alpha, d.host) == (card.intra.alpha, card.inter.alpha, None)
    assert card.hbm_bytes == 80 * 10**9 and card.peak_flops == 989e12 and card.hbm_bw == 3.35e12
    assert "v5e" not in LM.PROFILES
    with pytest.raises(KeyError, match="unknown link profile"):
        LM.get_profile("v5e")


# ---------------------------------------------------------------------------
# the memory plan: the terms priced as the reference prices them
# ---------------------------------------------------------------------------

CARRIES = {"stored": dict(prefetch_carry="stored"), "remat": dict(prefetch_carry="remat"),
           "host": dict(prefetch_carry="stored", carry_offload="host")}
# train terms the port prices by the reference's rule (logits_ce at a 2-byte
# compute dtype; activation_ckpt outside enc-dec; the hop-2 terms of the
# int8 wire)
SHARED_TRAIN = ("grad_accum", "int8_wire_scratch", "reorder_copy")
SHARED_SERVE = ("gather_buffers", "int8_wire_scratch", "reorder_copy", "activation_ckpt",
                "decode_logits")


@pytest.mark.parametrize("name", CONFIGS)
def test_shared_memory_terms_are_the_references(name):
    """Every registered config x p in {1, 2, 4, 8} x 1 or 2 replicas x the
    three gather wires x the carries x ``offload_opt`` x the fp32 and int8
    hop 2, in train mode (2 x 512 tokens a micro-step, 2 micro-steps), and
    in serve mode with KV pages of each dtype: each shared term equal to the
    reference's to fp64 rounding, the arguments the reference's less its
    step scalar (the port's is a host int) plus the stub frontend's rows."""
    port, ref = _models(name)
    family = port.cfg.family
    b, seq, micro = 2, 512, 2
    for p in (1, 2, 4, 8):
        for repl in (1, 2):
            grid = M.DeviceGrid(p, repl)
            for wire in ("fp32", "bf16", "int8"):
                for carry, ckw in CARRIES.items():
                    for offload in (False, True):
                        for hop2 in ("fp32", "int8"):
                            kw = dict(micro_steps=micro, local_batch=b, seq=seq,
                                      offload_opt=offload)
                            got = M.predict_footprint(
                                port, grid, GatherPolicy("inner_first", wire, None, True, **ckw),
                                SyncPolicy(hop2_wire_dtype=hop2), **kw)
                            want = RM.predict_footprint(
                                ref, grid, RGather("inner_first", wire, None, True, **ckw),
                                RSync("2hop", hop2), **kw)
                            case = (p, repl, wire, carry, offload, hop2)
                            shared = list(SHARED_TRAIN)
                            if wire != "fp32":
                                shared.append("logits_ce")
                            if family != "encdec":
                                shared.append("activation_ckpt")
                            if hop2 == "int8":
                                shared += ["hop2_staging", "hop2_qgz_scratch"]
                            for term in shared:
                                assert _close(got.components.get(term, 0.0),
                                              want.components.get(term, 0.0)), (case, term)
                            frames = M._frontend_rows(port.cfg)
                            extra = micro * b * frames * port.cfg.d_model * 2.0
                            assert _close(got.args_bytes, want.args_bytes - 4.0 + extra), case
    for kv in ("fp32", "bf16", "int8"):
        kw = dict(mode="serve", local_batch=2, seq=64, kv_pages_tokens=1024, kv_dtype=kv,
                  decode_batch=4, decode_ctx=256)
        for p in (1, 2, 4, 8):
            for wire in ("fp32", "bf16", "int8"):
                grid = M.DeviceGrid(p)
                got = M.predict_footprint(port, grid, GatherPolicy("outer_first", wire),
                                          SyncPolicy(), **kw)
                want = RM.predict_footprint(ref, grid, RGather("outer_first", wire), RSync(),
                                            **kw)
                for term in SHARED_SERVE:
                    if term == "decode_logits" and not port.cfg.n_heads:
                        continue
                    assert _close(got.components.get(term, 0.0),
                                  want.components.get(term, 0.0)), (kv, p, wire, term)
                if port.cfg.family in ("dense", "moe", "vlm") and \
                        M._kv_head_dim(port.cfg.resolved_head_dim) == port.cfg.resolved_head_dim:
                    assert M.kv_token_bytes(port, kv) == RM.kv_token_bytes(ref, kv)
                    assert _close(got.args_bytes, want.args_bytes), (kv, p, wire)


# ---------------------------------------------------------------------------
# the memory plan: the port's own terms
# ---------------------------------------------------------------------------

def _flat(model):
    return model.global_flat_shapes()


@pytest.mark.parametrize("name", ["llama3.2-1b", "recurrentgemma-2b", "whisper-large-v3",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
def test_port_terms_follow_their_rules(name, wire):
    """Each term the port prices differently, by the rule its docstring
    states (core/memplan.py)."""
    model = build_model(get_config(name), tp=1)
    cfg, shapes = model.cfg, _flat(model)
    cb = M._COMPUTE_BYTES[wire]
    scanned = {p.name for p in model.pools}
    max_flat = max(f for _, _, f in shapes.values())
    b, seq, micro = 2, 1024, 3
    vocab = model.vocab_padded
    s4 = sum(s * f * 4 for s, _, f in shapes.values())
    for carry, ckw in CARRIES.items():
        plan = M.predict_footprint(model, M.DeviceGrid(1), GatherPolicy("flat", wire, **ckw),
                                   SyncPolicy(), micro_steps=micro, local_batch=b, seq=seq)
        c = plan.components
        for absent in ("grad_loop_buffer", "boundary_reduced", "hop2_staging", "qgz_scratch"):
            assert absent not in c
        head = shapes[model.head.name][2] * cb
        assert c["gather_buffers"] == head
        logits = b * seq * vocab * (2 * cb + 4)
        assert c["logits_ce"] == logits
        adj = max_flat * (cb + 4 if cb < 4 else 4)
        assert c.get("gather_adjoint", 0.0) == max(adj - logits - head, 0.0)
        carried = 0.0
        for pool, (stack, _, flat) in shapes.items():
            if pool not in scanned or stack < 2:
                continue
            decoder = cfg.family == "encdec" and not pool.startswith("enc")
            carried += stack * flat * cb if carry == "stored" or decoder else flat * cb
        assert c["prefetch_carry"] == carried, carry
        rows = {p: (cfg.n_audio_frames if cfg.family == "encdec" and p.startswith("enc")
                    else seq) for p in scanned}
        assert c["activation_ckpt"] == sum(shapes[p][0] * b * rows[p] * cfg.d_model * cb
                                           for p in scanned)
        frames = cfg.n_audio_frames if cfg.family == "encdec" else 0
        assert plan.args_bytes == 3 * s4 + micro * b * (seq * 12 + frames * cfg.d_model * 2)
        assert plan.state_bytes == 3 * s4
    # no batch priced: the adjoint beyond the head's buffer; offload_opt:
    # one state copy
    bare = M.predict_footprint(model, M.DeviceGrid(1), GatherPolicy("flat", wire), SyncPolicy(),
                               offload_opt=True)
    head = shapes[model.head.name][2] * cb
    assert bare.components.get("gather_adjoint", 0.0) == max(
        max_flat * (cb + 4 if cb < 4 else 4) - head, 0.0)
    assert bare.args_bytes == bare.state_bytes == s4
    # replicas: hop 2 in place on fp32, two bucket casts on bf16; qgZ scratch
    for hop2, want in (("fp32", 0.0), ("bf16", 1.0), ("int8", 2.0)):
        plan = M.predict_footprint(model, M.DeviceGrid(2, 2), GatherPolicy("flat", wire),
                                   SyncPolicy(hop1_wire_dtype="int8", hop2_wire_dtype=hop2))
        shard4 = max(s * math.ceil(f / 2) * 4 for s, _, f in shapes.values())
        assert plan.components.get("hop2_staging", 0.0) == want * min(32e6, shard4)
        assert plan.components["qgz_scratch"] == max_flat * (2 * (1 + 4 / 128) + 2)
    # serve: the pool written in place, read through the table; int64 plan rows
    serve = M.predict_footprint(model, M.DeviceGrid(1), GatherPolicy("flat", wire),
                                SyncPolicy(), mode="serve", kv_pages_tokens=4096,
                                kv_dtype="bf16", decode_batch=8, decode_ctx=512,
                                decode_chunk=64, kv_max_blocks=32)
    assert "kv_pool_update" not in serve.components
    assert "kv_gather_view" not in serve.components
    pool = 4096 * M.kv_token_bytes(model, "bf16")
    assert serve.args_bytes == s4 + pool + 8 * (64 * 8 + 24 + 32 * 4 + 4)


def test_kv_pages_of_a_padded_head_dim():
    """bert-50b's head dim 204 is stored at the flash kernels' 256
    (runtime/paged.paged_cache_local): its pages cost 256 / 204 of the
    reference's, the int8 scales at ceil(256 / 128)."""
    model, ref = _models("bert-50b")
    dh = model.cfg.resolved_head_dim
    assert dh == 204 and M._kv_head_dim(dh) == 256
    for kv in ("fp32", "bf16"):
        assert M.kv_token_bytes(model, kv) == RM.kv_token_bytes(ref, kv) * 256 / 204
    hkv, layers = model.cfg.n_kv_heads, model.cfg.n_layers
    assert M.kv_token_bytes(model, "int8") == layers * 2 * hkv * (256 + 2 * 4)


@pytest.mark.parametrize("name", ["llama3.2-1b", "recurrentgemma-2b", "deepseek-moe-16b",
                                  "xlstm-125m", "whisper-large-v3", "bert-10b",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("offload_opt", [False, True])
def test_argument_bytes_are_init_states(name, offload_opt):
    """The plan's state bytes are exactly the bytes of the tensors
    ``init_state`` makes (the smoke configs, on the CPU): params, and m and
    v unless host-offloaded, at p 1 and at p 2 on rank 0."""
    model = build_model(smoke_variant(get_config(name)), tp=1)
    for topo in (MiCSTopology(), MiCSTopology(shard=2)):
        state = init_state(model, 0, device="cpu", topo=topo, offload_opt=offload_opt)
        parts = ("params",) if offload_opt else ("params", "m", "v")
        nbytes = sum(t.numel() * t.element_size() for part in parts
                     for t in state[part].values())
        plan = M.predict_footprint(model, M.DeviceGrid(topo.partition_size), GatherPolicy(),
                                   SyncPolicy(), offload_opt=offload_opt)
        assert plan.state_bytes == plan.args_bytes == nbytes, topo


def _hooked_saved_bytes(model, b: int, seq: int, chunk: int) -> int:
    """What one row of the model's first layer pool keeps for its backward,
    run for real on the CPU: every tensor ``saved_tensors_hooks`` packs and
    the graph still holds once the row has returned, each storage once,
    less the row's inputs."""
    import weakref

    from repro_torch.models import layers as L
    from repro_torch.models import lm

    comm = CommEngine(MiCSTopology())
    ctx = L.Ctx(mode="train", compute_dtype=torch.bfloat16, comm=comm, mlstm_chunk=chunk)
    pool = model.pools[0]
    gen = torch.Generator().manual_seed(0)
    full = (0.05 * torch.randn(pool.layout.flat_len, generator=gen)).bfloat16().requires_grad_()
    x = torch.randn(b, seq, model.cfg.d_model, generator=gen).bfloat16().requires_grad_()
    packed = []

    def pack(t):
        packed.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = lm._layer_from_full(pool, comm, ctx, x, full)
    inputs = {full.untyped_storage().data_ptr(), x.untyped_storage().data_ptr()}
    live = {}
    for ref in packed:
        t = ref()
        if t is not None and t.untyped_storage().data_ptr() not in inputs:
            live[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    del out
    return sum(live.values())


@pytest.mark.parametrize("name,chunk", [("xlstm-125m", 8), ("xlstm-125m", 16),
                                        ("xlstm-125m", 0), ("deepseek-moe-16b", 0),
                                        ("recurrentgemma-2b", 0)])
def test_layer_saved_bytes_are_what_a_row_saves(name, chunk, one_thread):
    """The ``layer`` moment's ``layer_saved`` term (``memplan.layer_saved_bytes``,
    traced on fake tensors; xLSTM's extended in a line from two and three
    chunks or steps) equals what ``saved_tensors_hooks`` sees one row save on
    the CPU, counted by storage: xLSTM's super-layer (three mLSTM blocks,
    chunkwise at two chunk sizes and as the timestep scan, and the sLSTM's
    scan states), an MoE layer (attention, the router and the [E, cap + 1,
    d] dispatch) and a griffin row (the RG-LRU's saved chunk starts)."""
    cfg = smoke_variant(get_config(name))
    model = build_model(cfg, tp=1)
    b, seq = 2, 64
    pool = model.pools[0]
    want = _hooked_saved_bytes(model, b, seq, chunk)
    got = M.layer_saved_bytes(cfg, 1, b, seq, mlstm_chunk=chunk)
    assert got[pool.name] == float(want)
    plan = M.predict_footprint(model, M.DeviceGrid(1), GatherPolicy(), SyncPolicy(),
                               micro_steps=2, local_batch=b, seq=seq, mlstm_chunk=chunk)
    assert plan.moments["layer"]["layer_saved"] == max(got.values())
    if name.startswith("xlstm"):  # the recurrences' saved states grow with the chunk count
        assert M.layer_saved_bytes(cfg, 1, b, 2 * seq, mlstm_chunk=chunk)["x"] > want


@pytest.mark.parametrize("name,b,seq,chunk,want", [
    ("llama3.2-1b", 2, 1024, 0, "loss"),
    ("xlstm-125m", 4, 1024, 64, "layer"),
    ("xlstm-125m", 2, 1024, 64, "boundary"),
    ("xlstm-125m", 0, 0, 0, "boundary")])
def test_describe_names_the_larger_moment(name, b, seq, chunk, want):
    """The plan is the largest of the step's moments and ``describe()``
    names it: llama's loss backward (its logits), xLSTM's largest row's
    backward at 4 x 1,024 tokens (its recurrences' saved states), and its
    AdamW boundary at 2 x 1,024 tokens and with no batch priced; the
    allocator's excess at xLSTM's moments is a term of its own."""
    model = build_model(get_config(name), tp=1)
    plan = M.predict_footprint(model, M.DeviceGrid(1), GatherPolicy(), SyncPolicy(),
                               micro_steps=2, local_batch=b, seq=seq, mlstm_chunk=chunk)
    d = plan.describe()
    assert d["moment"] == plan.moment == want
    assert d["moments"][want] == max(d["moments"].values())
    assert plan.total_bytes == plan.args_bytes + d["moments"][want]
    assert plan.temp_bytes == sum(plan.peak_components.values())
    # the allocator's excess at the moment is a term of its own
    excess = 0.0
    if want != "loss":
        share, term = {"layer": (M.LAYER_RESERVE_SHARE, "layer_saved"),
                       "boundary": (M.BOUNDARY_RESERVE_SHARE, "boundary_update")}[want]
        excess = share.get(model.cfg.family, 0.0) * d["moment_components"][want][term]
    assert (excess > 0) == name.startswith("xlstm")
    assert plan.reserve_excess == excess == d["reserve_excess"]
    assert plan.reserved_bytes == plan.total_bytes * M.RESERVE_FACTOR + excess
    # the loss's components stay the reference's decomposition
    assert d["components"] == plan.components and "logits_ce" not in plan.moments.get(
        "layer", {})


# ---------------------------------------------------------------------------
# the decision rules
# ---------------------------------------------------------------------------

CARRY_ORDER = ("stored", "remat", "host")


def _candidates(port, ref, extent, **kw):
    """(p, carry) -> (the port's gate, the reference's total), GiB, over a
    data axis of ``extent`` (the plan's own walk); the port's gate is its
    plan with the allocator's reserve (``memplan.fits``)."""
    out = {}
    for p in M.partition_size_candidates(extent):
        for carry in CARRY_ORDER:
            ckw = CARRIES[carry]
            grid = M.DeviceGrid(p, extent // p)
            out[p, carry] = (
                M.predict_footprint(port, grid, GatherPolicy(**ckw), SyncPolicy(),
                                    **kw).reserved_bytes / LM.GIB,
                RM.predict_footprint(ref, grid, RGather(**ckw), RSync(), **kw).total_gb)
    return out


@pytest.mark.parametrize("name", ["llama3.2-1b", "recurrentgemma-2b", "whisper-large-v3",
                                  "deepseek-moe-16b"])
def test_min_partition_size_is_the_papers_rule(name):
    """The smallest fitting partition group, the carries tried in the
    reference's order at each size; the same (p, carry) as the reference's
    wherever no candidate's budget test flips between the two planners
    (the budget outside every band between their totals);
    ``MemoryBudgetError`` names the smallest candidate."""
    port, ref = _models(name)
    extent, kw = 8, dict(micro_steps=2, local_batch=1, seq=1024)
    totals = _candidates(port, ref, extent, **kw)
    lo, hi = min(min(v) for v in totals.values()), max(max(v) for v in totals.values())
    agreed = []
    for i in range(41):
        budget = lo * 0.5 * (4 * hi / lo) ** (i / 40)
        order = [(p, c) for p in M.partition_size_candidates(extent) for c in CARRY_ORDER]
        fits = [k for k in order if totals[k][0] <= budget]
        call = dict(data_extent=extent, hbm_budget_gb=budget, carries=CARRY_ORDER, **kw)
        if not fits:
            smallest = min(order, key=lambda k: totals[k][0])
            with pytest.raises(M.MemoryBudgetError,
                               match=rf"smallest candidate \(p={smallest[0]}, "
                                     rf"prefetch_carry='{smallest[1]}'\)"):
                M.min_partition_size(port, **call)
        else:
            p, carry, plan = M.min_partition_size(port, **call)
            assert (p, carry) == fits[0] and plan.reserved_bytes / LM.GIB <= budget
        if all((t[0] <= budget) == (t[1] <= budget) for t in totals.values()):
            try:
                want = RM.min_partition_size(ref, gather=RGather(), sync=RSync(), **call)[:2]
            except RM.MemoryBudgetError:
                want = None
            assert (fits[0] if fits else None) == want, budget
            agreed.append(want)
    assert None in agreed and (1, "stored") in agreed and len(agreed) >= 4
    # resolve_scale: the same rule from a config, carries stored / remat / host
    budget = totals[2, "stored"][0] * 1.001
    mcfg = MiCSConfig(micro_steps=2, hbm_budget_gb=budget)
    p, carry, _ = A.resolve_scale(port, mcfg, data_extent=extent, local_batch=1, seq=1024)
    order = [(q, c) for q in M.partition_size_candidates(extent) for c in CARRY_ORDER]
    assert (p, carry) == next(k for k in order if totals[k][0] <= budget)
    with pytest.raises(ValueError, match="hbm_budget_gb"):
        A.resolve_scale(port, MiCSConfig(), data_extent=extent)


def _topos():
    return {"p4r2": MiCSTopology(shard=4, repl=2), "p2r4": MiCSTopology(shard=2, repl=4),
            "p16": MiCSTopology(shard=16),
            "pod2x8": MiCSTopology(pod=2, shard=8, partition_axes=("pod", "shard"),
                                   replication_axes=("repl", "dp2")),
            "p1": MiCSTopology()}


POLICIES = [GatherPolicy("flat", "bf16"), GatherPolicy("inner_first", "bf16", 2),
            GatherPolicy("outer_first", "int8", 4), GatherPolicy("outer_first", "fp32", None,
                                                                 True, "remat"),
            GatherPolicy("inner_first", "bf16", None, False),
            GatherPolicy("flat", "bf16", None, True, "stored", "host")]
SYNCS = [SyncPolicy(), SyncPolicy(hop1_wire_dtype="int8", hop2_wire_dtype="bf16"),
         SyncPolicy(hop1_wire_dtype="bf16", hop2_wire_dtype="int8")]


def _ref_policy(g: GatherPolicy, s: SyncPolicy):
    return (RGather(g.topology, g.wire_dtype, g.inner, g.prefetch, g.prefetch_carry,
                    g.carry_offload),
            RSync(s.mode, s.hop2_wire_dtype, s.hop1_wire_dtype))


def _one_event(stack, s, *, scanned, prefetch, mode, carry="stored"):
    return {"ag": 1.0, "rs": 1.0 if mode == "train" else 0.0}


def _port_counts(stack, s, *, scanned, prefetch, mode, carry="stored"):
    """The port's schedule's event counts (written out, PERF.md §4)."""
    if mode == "serve":
        return {"ag": float(stack), "rs": 0.0}
    if scanned and prefetch and stack > 1:
        ag = (2 if carry == "remat" else 1) * s * stack
    else:
        ag = (2 if scanned else 1) * s * stack
    return {"ag": float(ag), "rs": float(s * stack)}


@pytest.mark.parametrize("name", ["llama3.2-1b", "recurrentgemma-2b", "whisper-large-v3"])
def test_predict_traffic_and_hop2_cost_are_the_references(name, monkeypatch):
    """With the reference's event counts the census is the reference's
    (every stage, bytes, counts, tiers, the reorder copy); with the port's,
    each stage's bytes an event, group size and tier are the reference's
    and the events are the port's schedule's; ``cost_hop2_schedule`` is the
    reference's."""
    port, ref = _models(name)
    prof, rprof = v5e(), RL.V5E
    for tname, topo in _topos().items():
        for g in POLICIES:
            for s in SYNCS:
                rg, rs = _ref_policy(g, s)
                if (g.inner and g.topology != "flat" and topo.partition_size > 1
                        and len(topo.partition_axes) == 1 and topo.partition_size % g.inner):
                    for fn, mod, pol in ((A.predict_traffic, port, (g, s)),
                                         (RA.predict_traffic, ref, (rg, rs))):
                        with pytest.raises(ValueError, match="does not divide"):
                            fn(mod, topo, *pol)
                    continue
                for mode in ("train", "serve"):
                    if (port.cfg.family == "encdec" and mode == "train"
                            and (g.prefetch_carry == "remat" or g.carry_offload == "host")):
                        # the decoder pools keep the stored carry (both
                        # packages' schedules); the reference's census
                        # counts them as remat's: the port's own counts
                        # are held below
                        continue
                    kw = dict(micro_steps=3, mode=mode)
                    want = RA.predict_traffic(ref, topo, rg, rs, profile=rprof, **kw)
                    own = A.predict_traffic(port, topo, g, s, profile=prof, **kw)["by_stage"]
                    with monkeypatch.context() as mp:
                        mp.setattr(A, "_event_counts", RA._event_counts)
                        got = A.predict_traffic(port, topo, g, s, profile=prof, **kw)
                    case = (tname, g, s, mode)
                    assert set(got["by_stage"]) == set(want["by_stage"]) == set(own), case
                    assert _close(got["local_copy_bytes"], want["local_copy_bytes"]), case
                    with monkeypatch.context() as mp:   # one event a pool: bytes an event
                        mp.setattr(A, "_event_counts", _one_event)
                        mp.setattr(RA, "_event_counts", _one_event)
                        unit = A.predict_traffic(port, topo, g, s, **kw)["by_stage"]
                        runit = RA.predict_traffic(ref, topo, rg, rs, **kw)["by_stage"]
                    for stage, w in want["by_stage"].items():
                        e, o = got["by_stage"][stage], own[stage]
                        assert (e["group_size"], e["tier"], e["events"], e["count"]) == (
                            w["group_size"], w["tier"], w["events"], w["count"]), case
                        assert _close(e["wire_bytes"], w["wire_bytes"]), (case, stage)
                        assert (o["group_size"], o["tier"]) == (w["group_size"], w["tier"])
                        assert _close(unit[stage]["wire_bytes"], runit[stage]["wire_bytes"])
                    if mode == "train" and s == SYNCS[0]:
                        hop2 = {}
                        for boundary, mb, clip in (("serial", 32.0, "exact"),
                                                   ("bucketed", 4.0, "exact"),
                                                   ("bucketed", 128.0, "approx")):
                            kw2 = dict(boundary=boundary, bucket_mb=mb, clip_mode=clip)
                            hop2 = A.cost_hop2_schedule(port, topo, prof, s, **kw2)
                            assert hop2 == pytest.approx(
                                RA.cost_hop2_schedule(ref, topo, rprof, rs, **kw2)), case
    # the port's own counts, pool by pool
    topo = MiCSTopology(shard=2)
    for g in POLICIES:
        if g.inner and 2 % g.inner:
            continue
        for mode in ("train", "serve"):
            got = A.predict_traffic(port, topo, g, SyncPolicy(), micro_steps=3, mode=mode)
            flat = got["by_stage"]["param_gather.flat"]
            carry = "host" if g.carry_offload == "host" else g.prefetch_carry
            want = 0.0
            for pool in port.all_pools():
                stack = port.global_flat_shapes()[pool.name][0]
                decoder = port.cfg.family == "encdec" and not pool.name.startswith("enc")
                want += _port_counts(stack, 3, scanned=pool.name in {p.name for p in port.pools},
                                     prefetch=g.prefetch, mode=mode,
                                     carry="stored" if decoder else carry)["ag"]
            assert flat["events"] == want, (g, mode)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_rank_policies_is_the_references(profile, mode, monkeypatch):
    """No budget: with the reference's event counts the whole ranking (each
    candidate's keys and modeled time, in order) and the choice are the
    reference's on the same profile; with the port's own counts the choice
    is the reference's."""
    prof, rprof = (f() for f in PROFILES[profile])
    for name in ("llama3.2-1b", "recurrentgemma-2b"):
        port, ref = _models(name)
        for tname, topo in _topos().items():
            kw = dict(micro_steps=2, mode=mode)
            want = RA.rank_policies(ref, topo, rprof, **kw)
            own = A.rank_policies(port, topo, prof, **kw)
            with monkeypatch.context() as mp:
                mp.setattr(A, "_event_counts", RA._event_counts)
                got = A.rank_policies(port, topo, prof, **kw)
            assert [_key(c) for c in got.candidates] == [_key(c) for c in want.candidates]
            assert [c.t_comm_s for c in got.candidates] == [c.t_comm_s for c in want.candidates]
            assert [c.t_decode_s for c in got.candidates] == [
                c.t_decode_s for c in want.candidates]
            assert _key(got.chosen) == _key(want.chosen) == _key(own.chosen), (name, tname)


def _key(c):
    g, s = c.gather, c.sync
    return (g.topology, g.inner, g.wire_dtype, g.prefetch, g.prefetch_carry, g.carry_offload,
            s.hop1_wire_dtype, s.hop2_wire_dtype, c.boundary, c.hop2_bucket_mb, c.clip_mode,
            c.kv_dtype, c.resident_requests)


def test_lossy_candidates_are_ranked_not_chosen():
    """The int8 gather, the compressed hop-2 wires, qgZ and the approximate
    clip are ranked but chosen only under their own opt-in."""
    model = build_model(get_config("llama3.2-1b"), tp=1)
    prof = LM.custom_profile("slow-inter", intra_bw=100e9, inter_bw=1e9, node_size=8)
    topo = MiCSTopology(shard=16, repl=2)
    plan = A.rank_policies(model, topo, prof, micro_steps=2, prefetch=False)
    assert any(c.lossy_wire for c in plan.candidates)
    assert any(c.clip_mode == "approx" for c in plan.candidates)
    c = plan.chosen
    assert not (c.lossy_wire or c.lossy_hop2 or c.lossy_hop1) and c.clip_mode == "exact"
    hop2 = A.rank_policies(model, topo, prof, micro_steps=2, prefetch=False,
                           allow_bf16_hop2=True)
    assert hop2.chosen.sync.hop2_wire_dtype == "bf16"
    serve = A.rank_policies(model, topo, prof, mode="serve", allow_int8=True)
    assert serve.chosen.gather.wire_dtype == "int8"
    ceiling = A.rank_policies(model, topo, prof, mode="serve", kv_ceiling="fp32")
    assert {c.kv_dtype for c in ceiling.candidates} == {"fp32", "bf16", "int8"}
    assert ceiling.chosen.kv_dtype == "fp32"


@pytest.mark.parametrize("topo", ["p1", "p4r2", "pod2x8"])
def test_resolve_config_round_trips(topo):
    """``resolve_config`` writes the chosen policies back onto the config so
    that ``policies_from_config`` (what ``CommEngine.from_config`` reads)
    rebuilds exactly them, with a ``torch`` gather dtype; a manual config
    passes through; serve mode lands the KV dtype and the residency."""
    topology = _topos()[topo]
    model = build_model(get_config("llama3.2-1b"), tp=1)
    for kw in (dict(), dict(quant_gather=True, compress_hop2="int8", hop1_wire_dtype="int8"),
               dict(clip_mode="approx", offload_opt=True, hbm_budget_gb=60.0)):
        mcfg = MiCSConfig(policy="auto", link_profile="efa-100g", micro_steps=2, **kw)
        resolved, plan = A.resolve_config(mcfg, model, topology)
        assert resolved.policy == "manual" and resolved.gather_dtype in (torch.float32,
                                                                         torch.bfloat16)
        g, s = policies_from_config(resolved)
        assert g == plan.chosen.gather and s.hop1_wire_dtype == plan.chosen.sync.hop1_wire_dtype
        assert s.hop2_wire_dtype == plan.chosen.sync.hop2_wire_dtype
        assert (resolved.boundary_schedule, resolved.hop2_bucket_mb, resolved.clip_mode) == (
            plan.chosen.boundary, plan.chosen.hop2_bucket_mb, plan.chosen.clip_mode)
        if topology.world_size == 1:
            eng = CommEngine.from_config(topology, resolved)
            assert eng.gather_policy == plan.chosen.gather
    manual = MiCSConfig()
    assert A.resolve_config(manual, model, topology) == (manual, None)
    served, plan = A.resolve_config(MiCSConfig(policy="auto", kv_dtype="int8"), model, topology,
                                    mode="serve", seq=512)
    assert (served.kv_dtype, served.max_resident_requests, served.prefetch) == (
        plan.chosen.kv_dtype, plan.chosen.resident_requests, plan.chosen.gather.prefetch)


def test_resolve_world_repicks_p_and_the_carry():
    """A world change under a budget re-runs the §3.1 rule on the
    survivors: 8 -> 4 -> 2 devices at a budget the stored carry fits at p
    2, the remat carry rescuing p 1 at a lower one; the carry lands on the
    returned config."""
    model = build_model(get_config("recurrentgemma-2b"), tp=1)
    stored2 = M.predict_footprint(model, M.DeviceGrid(2, 1), GatherPolicy(),
                                  SyncPolicy()).reserved_bytes / LM.GIB
    remat1 = M.predict_footprint(model, M.DeviceGrid(1, 2), GatherPolicy(prefetch_carry="remat"),
                                 SyncPolicy()).reserved_bytes / LM.GIB
    for n in (8, 4, 2):
        p, mcfg, info = A.resolve_world(model, MiCSConfig(hbm_budget_gb=stored2 * 1.0001),
                                        n_devices=n, partition_size=1)
        assert (p, mcfg.prefetch_carry, info["rule"]) == (2, "stored", "resolve_scale")
    p, mcfg, info = A.resolve_world(model, MiCSConfig(hbm_budget_gb=remat1 * 1.0001),
                                    n_devices=2)
    assert (p, mcfg.prefetch_carry, mcfg.carry_offload, info["carry"]) == (1, "remat", "none",
                                                                          "remat")


def test_budget_gates_hold_the_reserve_and_the_batch(tmp_path):
    """A budget holds the plan with the allocator's reserve
    (``RESERVE_FACTOR``) and, where the caller knows them, the batch, the
    activations and the logits: recurrentgemma-2b at p 1 on one card's
    train shapes (2 rows x 2048 tokens, 4 micro-steps) is refused at a
    budget its states alone fit, and at one between its plan and its
    reserve; the train launcher and the train loop pass the batch."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train_loop import LoopConfig, train

    model = build_model(get_config("recurrentgemma-2b"), tp=1)
    shapes = dict(local_batch=2, seq=2048)
    remat = GatherPolicy(prefetch_carry="remat")
    bare = M.predict_footprint(model, M.DeviceGrid(1), remat, SyncPolicy(), micro_steps=4)
    full = M.predict_footprint(model, M.DeviceGrid(1), remat, SyncPolicy(), micro_steps=4,
                               **shapes)
    assert full.reserved_bytes == full.total_bytes * M.RESERVE_FACTOR > bare.reserved_bytes
    assert M.fits(full.total_bytes, full.reserved_bytes / LM.GIB)
    between = (full.total_bytes + full.reserved_bytes) / 2 / LM.GIB
    states_only = bare.reserved_bytes * 1.001 / LM.GIB
    for budget in (states_only, between):
        mcfg = MiCSConfig(policy="auto", micro_steps=4, hbm_budget_gb=budget)
        admitted, _ = A.resolve_config(mcfg, model, MiCSTopology())   # states only
        assert admitted.prefetch_carry == "remat"
        with pytest.raises(M.MemoryBudgetError, match="reserves"):
            A.resolve_config(mcfg, model, MiCSTopology(), **shapes)
        with pytest.raises(M.MemoryBudgetError, match="reserves"):
            M.min_partition_size(model, data_extent=1, hbm_budget_gb=budget, micro_steps=4,
                                 carries=CARRY_ORDER, **shapes)
    mcfg = MiCSConfig(policy="auto", micro_steps=4, hbm_budget_gb=full.reserved_bytes / LM.GIB)
    got, _ = A.resolve_config(mcfg, model, MiCSTopology(), **shapes)
    assert got.prefetch_carry == "remat"
    # the entry points price their own batch: smoke llama's states fit this
    # budget, its batch does not
    smoke = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    bare = M.predict_footprint(smoke, M.DeviceGrid(1), remat, SyncPolicy(), micro_steps=2)
    budget = bare.reserved_bytes * 1.01 / LM.GIB
    with pytest.raises(M.MemoryBudgetError):
        train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "1",
                        "--policy", "auto", "--hbm-budget-gb", str(budget),
                        "--checkpoint-dir", str(tmp_path / "ck")])
    with pytest.raises(M.MemoryBudgetError):
        train(smoke, MiCSTopology(), MiCSConfig(policy="auto", hbm_budget_gb=budget),
              OptConfig(), DataConfig(vocab=smoke.cfg.vocab, seq=128, global_batch=16,
                                      micro_steps=2),
              LoopConfig(total_steps=1, checkpoint_dir=str(tmp_path / "ck2")), device="cpu")


def test_resize_for_serve_world_reranks_with_numerics_pinned():
    """The serve world's rebuild re-ranks the serve policy on the new
    topology and pins the numerics to the config's: its fp32 gather and
    int8 KV stay, whatever the re-rank would pick; ``serve_rerank`` records
    the re-ranked policy."""
    from repro_torch.runtime.serving import resize_for_serve_world

    model = build_model(get_config("llama3.2-1b"), tp=1)
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype="int8", kv_block_size=8,
                      link_profile="efa-400g")
    topo, mcfg2, info = resize_for_serve_world(model, mcfg, 4, partition_size=4, available=8,
                                               seq=256)
    assert (topo.world_size, topo.partition_size) == (4, 4)
    assert (mcfg2.gather_dtype, mcfg2.kv_dtype, mcfg2.kv_block_size, mcfg2.policy) == (
        torch.float32, "int8", 8, "manual")
    _, plan = A.rerank_serve_world(model, topo, mcfg, seq=256)
    rr = info["serve_rerank"]
    assert (rr["gather"], rr["prefetch"], rr["kv_dtype"]) == (
        plan.chosen.gather.topology, plan.chosen.gather.prefetch, "int8")
    assert rr["max_resident_requests"] == mcfg2.max_resident_requests > 0


def test_serve_loop_caps_residency_at_the_planners():
    """``ResilientServeLoop`` caps the batcher's residency at the config's
    ``max_resident_requests`` (the planner's, once resolved) unless its own
    ``resident_cap`` is set, and takes the re-ranked config's after a world
    rebuild."""
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    geometry = dict(slots_local=2, nb_local=9, block_size=4, max_blocks=4, chunk=4)
    auto = MiCSConfig(policy="auto", gather_dtype=torch.float32, kv_dtype="fp32",
                      kv_block_size=4, max_resident_requests=1)
    mcfg, plan = A.resolve_config(auto, model, MiCSTopology(), mode="serve", seq=16)
    assert mcfg.max_resident_requests == plan.chosen.resident_requests == 1
    loop = ResilientServeLoop(model, MiCSTopology(), mcfg, ServeLoopConfig(**geometry),
                              device="cpu")
    assert loop.batcher.resident_cap == 1
    own = ResilientServeLoop(model, MiCSTopology(), mcfg,
                             ServeLoopConfig(**geometry, resident_cap=2), device="cpu")
    assert own.batcher.resident_cap == 2
    manual = ResilientServeLoop(model, MiCSTopology(), dataclasses.replace(
        mcfg, max_resident_requests=0), ServeLoopConfig(**geometry), device="cpu")
    assert manual.batcher.resident_cap == 0          # no cap
    manual._rebuild({"world": 1})
    assert manual.batcher.resident_cap == manual.mcfg.max_resident_requests > 0


def test_launchers_run_under_auto(tmp_path, capsys):
    """``launch/train.py --policy auto --link-profile efa-100g
    --hbm-budget-gb`` prints the ranking, the hop-2 costing and the memory
    plan and trains a step; ``launch/serve.py --policy auto`` serves on the
    chosen serve policy."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "1",
                    "--policy", "auto", "--link-profile", "efa-100g", "--hbm-budget-gb", "2",
                    "--checkpoint-every", "0", "--checkpoint-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "autotune[efa-100g] mode=train hbm_budget=2GiB" in out
    assert "modeled hop-2" in out and "memplan: " in out and "final loss " in out
    serve_cli.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--decode-tokens",
                    "2", "--policy", "auto", "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "autotune[h100-p5] mode=serve" in out and "serve policy: kv_dtype=" in out
    assert "sampled ids:" in out
