"""The port's tensor-parallel layers (tp 4; the MoE cases also at p 2 x tp 2)
in one 4-rank gloo world on the CPU, against the JAX package's layer
functions on 4 virtual devices under
``shard_map(..., check_vma=False)`` with the same inputs and cotangents
(``torch_dist_cases.py``), and against the port's own layers at tp = 1 on
the full tensors.

Both packages transpose a psum to a psum and a tiled model gather to a
reduce-scatter, so with a cotangent that is the same on every rank, the
gradient of a model-sharded input is tp times its slice of the tp = 1
gradient, and the gradients of an input every rank holds whole (the
activations, a gathered norm scale) add up over the ranks to tp times the
tp = 1 one.  The training step seeds its backward with 1/tp to undo this
(``core/mics.accumulate_grads``); the reference does not (ROADMAP Queue
3).

Tolerances: fp32 cases within ``FP32_REL`` of the largest value (the same
sums in other orders); bf16 cases within ``BF16_ULPS`` bf16 ulps of the
largest value against JAX (both round each product and each psum, gloo and
XLA summing 4 ranks in their own orders) and bitwise against a second run
of the port; the gathers bitwise, their adjoints and the mask and argmax
cases exactly against numpy."""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.models import blocks, lm, recurrent  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.dims import attn_dims  # noqa: E402

FP32_REL = 2e-6
BF16_ULPS = 2
CTX1 = L.Ctx(mode="train", compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_layers")
    jax_proc = K.start("jax_dist_oracle.py", "tp_layers", str(out))
    port = K.start("torch_dist_harness.py", "tp_layers", str(out))
    K.finish(port, 240)
    K.finish(jax_proc, 240)
    return (K.load_ranks(str(out / "port_tp_layers.rank{r}.npz")),
            dict(np.load(out / "jax_tp_layers.npz")))


def _close(got, want, rel=FP32_REL, what=""):
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * max(scale, 1e-30), f"{what}: max |err| {err} > {rel} x {scale}"


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _outputs(got: dict, case: str) -> list[str]:
    return [k for k in got if k.startswith(case + ".") and ".again." not in k
            and not k.endswith(".calls")]


@pytest.mark.parametrize("case", [c for c in K.TP_LAYER_CASES if c != "head_mask"])
def test_tp_layer_matches_jax(results, case):
    got, want = results
    for key in _outputs(got, case):
        if case.endswith(":bf16"):
            err = float(np.abs(got[key] - want[key]).max())
            lim = BF16_ULPS * _bf16_ulp(float(np.abs(want[key]).max()))
            assert err <= lim, f"{key}: max |err| {err} > {BF16_ULPS} bf16 ulps ({lim})"
            again = got[key.replace(case + ".", case + ".again.")]
            assert np.array_equal(again, got[key]), f"{key}: not bitwise on a second run"
        elif case.startswith(("gather", "greedy")) and not key.endswith(".grad"):
            assert np.array_equal(got[key], want[key]), key
        else:
            _close(got[key], want[key], what=key)


@pytest.mark.parametrize("case", ["gather:4", "gather:2", "gather:4_dim0"])
def test_model_gather_and_its_adjoint_match_numpy(results, case):
    """``flat_param.model_gather_fn_for`` over the whole model group (norm
    scales; an MQA head at kv_gather = tp) and over runs of 2 ranks (2 KV
    heads at tp 4, the reference's ``axis_index_groups``): the gather
    bitwise, the reduce-scatter within fp32 rounding, on the JAX side too."""
    got, want = results
    ref = K.gather_oracle(case)
    assert np.array_equal(got[f"{case}.out"], ref["out"])
    _close(got[f"{case}.grad"], ref["grad"], what="port")
    _close(want[f"{case}.grad"], ref["grad"], what="jax")
    label = "kv" if case == "gather:2" else "model"
    assert json.loads(str(got[f"{case}.calls"][0])) == {f"all_gather:{label}": 1,
                                                        f"reduce_scatter:{label}": 1}


# The MoE cases' collectives a call: the expert exchange 2 a dispatch in
# the forward and 2 in the backward (each the other's adjoint); the
# token-sharded path's gather of y and its reduce-scatter, and aux's mean
# over the model group (a psum forward and backward); the shared experts'
# psum forward and backward.  The replicated (decode) path gathers nothing.
MOE_CALLS = {
    "moe_a2a": {"all_to_all:model": 2},
    "moe_ffn": {"all_to_all:model": 4, "all_gather:model": 1, "reduce_scatter:model": 1,
                "all_reduce:model": 4},
    "moe_dec": {"all_to_all:model": 4, "all_reduce:model": 2},
}


@pytest.mark.parametrize("case", [c for c in K.TP_LAYER_CASES if c.startswith("moe")])
def test_moe_collective_counts(results, case):
    """The expert exchange (``collectives.ModelAllToAll``), the token-sharded
    path and the replicated decode path at tp 4 and tp 2 issue the
    collectives of ``MOE_CALLS``, over the model group alone; their values
    are held to JAX by ``test_tp_layer_matches_jax``."""
    got, _ = results
    assert json.loads(str(got[f"{case}.calls"][0])) == MOE_CALLS[case.split("@")[0]]


@pytest.mark.parametrize("case", K.MOE_LIVE_CASES)
def test_moe_dead_rows_over_ranks_against_tp1(results, case):
    """The engine's decode step at tp 2 and 4 (4 slots of 8 rows, n_new 8,
    1, 0, 3; token-sharded, 16 and 8 rows a rank): the live rows' outputs
    are the port's at tp 1 on the full weights, on every rank, and the dead
    rows take no expert slot there either (their values reach no live
    row: a second tp 1 run with other dead rows gives the same live bits)."""
    from repro_torch.runtime.paged import PageState

    got, _ = results
    full, _ = K.tp_layer_case(case)
    cfg = smoke_variant(get_config("deepseek-moe-16b"))
    n_new = torch.tensor(K.MOE_LIVE_N_NEW)
    ctx = L.Ctx(mode="decode", compute_dtype=torch.float32, pages=PageState(None, 0, n_new))
    t = {n: torch.from_numpy(full[n]) for n in K.MOE_CUT}
    x = torch.from_numpy(full["x"])
    live = (torch.arange(x.shape[1])[None, :] < n_new[:, None]).numpy()
    want, _ = blocks.moe_ffn(t, x, cfg, ctx)
    other = torch.where(torch.from_numpy(live)[..., None], x, 3.0 * x.flip(1))
    again, _ = blocks.moe_ffn(t, other, cfg, ctx)
    assert torch.equal(want[torch.from_numpy(live)], again[torch.from_numpy(live)])
    for r in range(K.WORLD):
        _close(got[f"{case}.out"][r][live], want.numpy()[live], FP32_REL * 4, f"rank {r}")


def test_local_head_mask_with_padding(results):
    """10 Q heads padded to 12 at tp 4: rank 3 holds head 9 and two padded
    heads."""
    got, want = results
    assert np.array_equal(got["head_mask.mask"], K.head_mask_oracle())
    assert np.array_equal(want["head_mask.mask"], K.head_mask_oracle())


def test_groups_are_the_jax_mesh(results):
    """The model group of a rank is its mesh row along the model axis (tp
    consecutive ranks), its KV run at tp 4 the reference's contiguous
    ``axis_index_groups`` of 2 model indices, and at p 2 x tp 2 the
    partition and data groups hold the ranks of one model coordinate."""
    got, want = results
    t4 = want["groups.T4.devices"].reshape(-1, K.TP)
    p2t2 = want["groups.P2T2.devices"]
    for r in range(K.WORLD):
        assert got["groups.T4.model"][r].tolist() == t4[0].tolist()
        assert got["groups.T4.kv2"][r].tolist() == t4[0, r // 2 * 2:r // 2 * 2 + 2].tolist()
        coords = T.MiCSTopology(**K.topo_kwargs("P2T2")).rank_coords(r)
        row = p2t2[0, 0, coords["shard"], 0, :].tolist()
        col = p2t2[0, 0, :, 0, coords["model"]].tolist()
        assert got["groups.P2T2.model"][r].tolist() == row
        assert got["groups.P2T2.partition"][r].tolist() == col
        assert got["groups.P2T2.data"][r].tolist() == col


# ---------------------------------------------------------------------------
# against the port at tp = 1 on the full tensors
# ---------------------------------------------------------------------------

def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).float().requires_grad_(True)


def _slices(a: np.ndarray, axis: int) -> np.ndarray:
    return np.stack(np.split(a, K.TP, axis=axis))


def test_embed_lookup_against_tp1(results):
    got, _ = results
    full, _ = K.tp_layer_case("embed")
    table = _leaf(full["table"])
    y = L.embed_lookup(table, torch.from_numpy(full["ids"]).long(), CTX1)
    (g,) = torch.autograd.grad(y, table, torch.from_numpy(full["ct"]))
    for r in range(K.WORLD):
        assert np.array_equal(got["embed.out"][r], y.detach().numpy())
    _close(got["embed.d_table"], K.TP * _slices(g.numpy(), 1), what="d_table")


def test_cross_entropy_loss_and_gradient_times_tp(results):
    """The vocab-parallel loss is the tp = 1 loss on every rank (padded
    columns 37-39 masked by global column, targets in every rank's
    columns); its gradient with a cotangent of 1 is tp times the tp = 1
    gradient's slice, the target's -w only on the rank holding it."""
    got, _ = results
    full, _ = K.tp_layer_case("xent")
    logits = _leaf(full["logits"])
    loss = L.tp_cross_entropy(logits, torch.from_numpy(full["targets"]),
                              torch.from_numpy(full["mask"]), vocab_real=K.VR,
                              vocab_padded=K.VP, ctx=CTX1)
    (g,) = torch.autograd.grad(loss, logits)
    _close(got["xent.loss"], np.full(K.WORLD, loss.item()), what="loss")
    _close(got["xent.d_logits"], K.TP * _slices(g.numpy(), 2), what="d_logits")
    assert not got["xent.d_logits"][3][..., K.VR - 30:].any()   # padded columns
    calls = json.loads(str(got["xent.calls"][0]))
    assert calls == {"all_reduce_max:model": 1, "all_reduce:model": 3}


def test_attn_out_against_tp1(results):
    """Head padding: 6 Q heads padded to 8; the padded heads' outputs are
    masked, so the output is the tp = 1 one, their ``wo`` rows and their
    attention outputs get no gradient, and the real ones tp times theirs."""
    got, _ = results
    full, ranks = K.tp_layer_case("attn_out:fp32")
    a = K.ATTN
    ad = attn_dims(a["d"], a["hq"], a["hkv"], a["dh"], 1)
    attn, wo = _leaf(full["attn"]), _leaf(full["wo"])
    y = blocks.attn_out({"attn.wo": wo}, attn, ad, CTX1, "attn.", bias=False)
    d_attn, d_wo = torch.autograd.grad(y, (attn, wo), torch.from_numpy(full["ct"]))
    for r in range(K.WORLD):
        _close(got["attn_out:fp32.out"][r], y.detach().numpy(), what="out")
    wo_pad = np.zeros((8 * a["dh"], a["d"]), np.float32)
    wo_pad[:a["hq"] * a["dh"]] = d_wo.numpy()
    _close(got["attn_out:fp32.d_wo"], K.TP * _slices(wo_pad, 0), what="d_wo")
    heads = d_attn.numpy().reshape(K.B, K.T, a["hq"], a["dh"])
    heads = np.concatenate([heads, np.zeros((K.B, K.T, 2, a["dh"]), np.float32)], axis=2)
    per = heads.reshape(K.B, K.T, K.TP, 1, 2, a["dh"]).transpose(2, 0, 1, 3, 4, 5)
    _close(got["attn_out:fp32.d_attn"], K.TP * per, what="d_attn")
    assert not got["attn_out:fp32.d_attn"][3][:, :, :, :].any()   # heads 6 and 7


@pytest.mark.parametrize("wire", ["fp32", "bf16"])
def test_mlp_against_tp1(results, wire):
    """Column-parallel gate / up, row-parallel down and the psum: the
    output is the tp = 1 one; the weights' gradients are tp times their
    slices, the input's add up over the ranks to tp times its gradient
    (bf16: within 3 % of the largest value, each rank's partial product
    and the psum rounded to bf16 in another order)."""
    got, _ = results
    full, _ = K.tp_layer_case(f"mlp:{wire}")
    cfg = ArchConfig(name="m", family="dense", n_layers=1, d_model=16, n_heads=4,
                     n_kv_heads=4, d_ff=32, vocab=256)
    dt = torch.float32 if wire == "fp32" else torch.bfloat16
    xs = [_leaf(full[k]).detach().to(dt).requires_grad_(True) for k in ("x", "wg", "wu", "wd")]
    y = blocks.mlp_apply(cfg, {"mlp.wg": xs[1], "mlp.wu": xs[2], "mlp.wd": xs[3]}, xs[0], CTX1)
    g = [t.float().numpy() for t in torch.autograd.grad(y, xs, torch.from_numpy(
        full["ct"]).to(dt))]
    rel = FP32_REL * 4 if wire == "fp32" else 3e-2
    key = f"mlp:{wire}"
    for r in range(K.WORLD):
        _close(got[f"{key}.out"][r], y.detach().float().numpy(), rel, "out")
    _close(got[f"{key}.d_x"].sum(0), K.TP * g[0], rel, "d_x")
    _close(got[f"{key}.d_wg"], K.TP * _slices(g[1], 1), rel, "d_wg")
    _close(got[f"{key}.d_wu"], K.TP * _slices(g[2], 1), rel, "d_wu")
    _close(got[f"{key}.d_wd"], K.TP * _slices(g[3], 0), rel, "d_wd")


def test_griffin_rec_against_tp1(results):
    """The LRU width cut over 4 ranks (16 channels each: the conv, the
    gates and the RG-LRU run on them), psums after ``rec.wo`` and
    ``mlp.wd``: the output is the tp = 1 layer's; the sharded tensors'
    gradients are tp times their slices, the whole ones' (x and the norm
    scales) add up to tp times theirs."""
    got, _ = results
    full, _ = K.tp_layer_case("griffin_rec")
    cfg = smoke_variant(get_config("recurrentgemma-2b"))
    t = {n: _leaf(full[n]) for n in K.GRIFFIN_REC_CUT}
    x = _leaf(full["x"])
    y, _ = recurrent.griffin_rec_apply(cfg, t, x, CTX1)
    grads = torch.autograd.grad(y, (x, *t.values()), torch.from_numpy(full["ct"]))
    rel = 2e-5      # the recurrence's fp32 sums over 8 steps, in another order
    for r in range(K.WORLD):
        _close(got["griffin_rec.out"][r], y.detach().numpy(), rel, "out")
    _close(got["griffin_rec.d_x"].sum(0), K.TP * grads[0].numpy(), rel, "d_x")
    for (n, axis), g in zip(K.GRIFFIN_REC_CUT.items(), grads[1:]):
        want = g.numpy() * K.TP
        part = got[f"griffin_rec.d_{n}"]
        if axis is None:
            _close(part.sum(0), want, rel, n)
        else:
            _close(part, _slices(want, axis), rel, n)
    assert json.loads(str(got["griffin_rec.calls"][0])) == {"all_reduce:model": 4}


def test_greedy_sample_tp_branch(results):
    """The local argmax, pmax of the maxima, pmin of the candidates: the
    tp = 1 argmax over the real columns, ties to the lowest column across
    ranks, a padded column's maximum ignored."""
    got, _ = results
    full, _ = K.tp_layer_case("greedy")
    want = lm.greedy_sample(torch.from_numpy(full["logits"]), CTX1, K.VR).numpy()
    assert want.tolist() == [int(np.argmax(full["logits"][i, :K.VR])) for i in range(3)]
    assert want[1] == 5
    for r in range(K.WORLD):
        assert got["greedy.ids"][r].tolist() == want.tolist()


# ---------------------------------------------------------------------------
# the state at tp > 1: init, checkpoints, the launcher
# ---------------------------------------------------------------------------

def test_init_params_at_tp_does_not_depend_on_p():
    """A rank's shards are its model coordinate's rows cut to its partition
    chunk: at p 2 x tp 2 they are the chunks of the p = 1 rows."""
    from repro_torch.core.mics import init_params
    from repro_torch.models.build import build_model

    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=2)
    p2t2 = T.MiCSTopology(**K.topo_kwargs("P2T2"))
    whole = {m: init_params(model, 5, device="cpu", topo=T.MiCSTopology(model=2), rank=m)
             for m in range(2)}
    assert not torch.equal(whole[0]["layers"], whole[1]["layers"])
    for r in range(K.WORLD):
        c = p2t2.rank_coords(r)
        got = init_params(model, 5, device="cpu", topo=p2t2, rank=r)
        for name, t in got.items():
            n = t.shape[-1]
            assert t.shape[1] == 1
            assert torch.equal(t, whole[c["model"]][name][..., c["shard"] * n:(c["shard"] + 1) * n])


def test_restore_onto_another_tp_raises(tmp_path):
    """The manifest records each rank's mesh coordinates; a restore onto
    another tp raises with the reference's reason: flat layouts are
    TP-local."""
    from repro_torch.checkpoint.checkpointer import MANIFEST, Checkpointer
    from repro_torch.core.mics import init_state
    from repro_torch.models.build import build_model

    cfg = smoke_variant(get_config("llama3.2-1b"))
    Checkpointer(tmp_path).save(init_state(build_model(cfg, tp=1), 0, device="cpu"), 1,
                                topo=T.MiCSTopology())
    meta = json.loads((tmp_path / "step_00000001" / MANIFEST).read_text())
    assert meta["rank_coords"] == [dict.fromkeys(T.MICS_AXES, 0)]
    with pytest.raises(ValueError, match="TP degree is fixed"):
        Checkpointer(tmp_path).restore(build_model(cfg, tp=2), topo=T.MiCSTopology(model=2),
                                       device="cpu")


def test_launcher_trains_at_p2_tp2_under_torchrun(tmp_path):
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", "recurrentgemma-2b", "--smoke",
         "--device", "cpu", "--dist-backend", "gloo", "--partition-size", "2", "--tp", "2",
         "--steps", "2", "--seq", "32", "--global-batch", "8", "--dist-timeout-s", "120",
         "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert any(ln.startswith("ranks: 4 over gloo, p=2") and "tp=2" in ln for ln in lines), lines
    assert lines[-1].startswith("final loss ") and "over 2 steps on cpu" in lines[-1]
    assert len(list((tmp_path / "ck" / "step_00000002").glob("params.*.rank*.npy"))) == 12
