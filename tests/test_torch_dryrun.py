"""The port's dry run (``repro_torch/launch/dryrun.py``), its counted step
statistics (``roofline/op_stats.py``) and roofline (``roofline/analysis.py``)
against the JAX package's, on the CPU at smoke widths.

* ``SHAPES`` and ``cells()`` are the reference's;
* ``roofline_terms``, ``build_table`` and ``markdown_table`` give the
  reference's numbers bit for bit on one record, the profile built field by
  field as the reference's ``v5e``; the default profile is ``h100-p5``;
* the cells of a fake world of 16 ranks (:data:`CELLS`): each rank-0 step's
  census equals ``predict_traffic``'s calls and wire bytes at every stage,
  its hop-2 collectives the bucket plan's, its ``memplan`` the planner's at
  the same arguments, and its record reads back through ``build_table``;
* the smoke llama train cell's counted ``dot_flops`` against the
  reference's ``hlo_stats.analyze`` of the compiled step (a subprocess with
  16 virtual devices, ``tests/dryrun_flops_harness.py``), within 1% once the
  port's attention backward's score recompute is taken off;
* each kernel wrapper's reported products against the plain version's, as
  ``FlopCounterMode`` counts them;
* a dense smoke cell's counted products equal the config's
  (``analysis.dense_rank_dot_flops``), the count the card's ``dryrun``
  phase holds its cells to.
"""

from __future__ import annotations

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from harness_util import run_harness  # noqa: E402

from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import cells as r_cells  # noqa: E402
from repro.core import linkmodel as RL  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro_torch.configs import SHAPES, cells, get_config, smoke_variant  # noqa: E402
from repro_torch.core import linkmodel as LM  # noqa: E402
from repro_torch.core import memplan as M  # noqa: E402
from repro_torch.core.comm import policies_from_config  # noqa: E402
from repro_torch.core.mics import MiCSConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402

HARNESS = pathlib.Path(__file__).parent / "dryrun_flops_harness.py"
# (pods, data, model): 16 ranks; p 4 over the 8 data ranks, so each cell
# runs the staged gather, its adjoint and hop 2 over two replicas, at tp 2
WORLD, P = (1, 8, 2), 4
# (arch, shape, seq, global batch, mlstm_chunk): smoke widths, cut seq and batch
CELLS = (("llama3.2-1b", "train_4k", 32, 32, 0),
         ("llama3.2-1b", "decode_32k", 64, 16, 0),
         ("deepseek-moe-16b", "train_4k", 32, 32, 0),
         ("xlstm-125m", "train_4k", 32, 32, 16))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_and_cells_are_the_references():
    assert SHAPES == R_SHAPES
    for skips in (False, True):
        port = [(c.name, s, spec, skip) for c, s, spec, skip in cells(include_skips=skips)]
        ref = [(c.name, s, spec, skip) for c, s, spec, skip in r_cells(include_skips=skips)]
        assert port == ref
    assert len(list(cells())) < len(list(cells(include_skips=True)))


def _v5e() -> LM.LinkProfile:
    r = RL.V5E
    link = lambda x: LM.Link(bandwidth=x.bandwidth, alpha=x.alpha)  # noqa: E731
    return LM.LinkProfile(name=r.name, intra=link(r.intra), inter=link(r.inter),
                          node_size=r.node_size, local_copy_bw=r.local_copy_bw,
                          peak_flops=r.peak_flops, hbm_bw=r.hbm_bw, hbm_bytes=r.hbm_bytes,
                          host=link(r.host))


def _record(arch, shape, mesh, **stats):
    spec = SHAPES[shape]
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": spec["kind"],
            "seq": spec["seq"], "global_batch": spec["global_batch"], "partition_size": 4,
            "active_params": 1_235_814_400, "tag": "",
            "stats": {"dot_flops": 3.1e13, "hbm_bytes": 4.7e11, "ici_wire_bytes": 2.3e10,
                      "dci_wire_bytes": 1.9e9, **stats}}


def test_roofline_is_the_references_on_v5e(tmp_path, monkeypatch):
    recs = [_record("llama3.2-1b", "train_4k", "16x16"),
            _record("llama3.2-1b", "decode_32k", "2x16x16", dot_flops=2.0e9, hbm_bytes=9.5e9),
            _record("qwen1.5-110b", "prefill_32k", "16x16", ici_wire_bytes=8.0e11)]
    (tmp_path / "dryrun").mkdir()
    for i, rec in enumerate(recs):
        (tmp_path / "dryrun" / f"{i}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(RA, "ART", tmp_path)
    v5e = _v5e()
    for rec in recs:
        assert A.roofline_terms(rec, v5e) == RA.roofline_terms(rec)
        assert A.model_flops_per_device(rec) == RA.model_flops_per_device(rec)
    rows, ref_rows = A.build_table(profile=v5e, art=tmp_path), RA.build_table()
    keys = ("arch", "shape", "mesh", "p", "compute_s", "memory_s", "collective_s", "ici_s",
            "dci_s", "dominant", "useful_ratio", "roofline_fraction")
    assert [{k: r[k] for k in keys} for r in rows] == [{k: r[k] for k in keys}
                                                       for r in ref_rows]
    for mesh in ("16x16", None):
        ref_table = RA.markdown_table(ref_rows, mesh=mesh)
        assert A.markdown_table(rows, mesh=mesh) == ref_table
    # the default profile is the card's
    card = A.roofline_terms(recs[0])
    assert card == A.roofline_terms(recs[0], "h100-p5")
    assert card["compute_s"] == recs[0]["stats"]["dot_flops"] / 989e12
    assert A.roofline_terms(recs[0], LM.H100_P5)["memory_s"] == 4.7e11 / 3.35e12


@pytest.mark.parametrize("arch,shape,seq,gb,chunk", CELLS)
def test_fake_world_cell(arch, shape, seq, gb, chunk, tmp_path, one_thread):
    """Rank 0 of a 16-rank fake world runs the smoke cell on the CPU: its
    census is ``predict_traffic``'s at every stage (calls and wire bytes),
    its hop-2 collectives the bucket plan's, its ``memplan`` the planner's,
    and its record is a row of ``build_table``."""
    cfg = smoke_variant(get_config(arch))
    micro = D.TRAIN_MICRO_STEPS if shape == "train_4k" else 1
    mcfg = MiCSConfig(micro_steps=micro, mlstm_chunk=chunk)
    rec = D.run_cell(arch, shape, False, mcfg, out_dir=tmp_path / "dryrun", cfg=cfg,
                     device="cpu", world=WORLD, seq=seq, global_batch=gb, partition_size=P,
                     ran="storage")
    assert rec["ran"] == "storage" and rec["mesh"] == "8x2" and rec["tp"] == 2
    assert rec["partition_size"] == P and rec["replication_degree"] == 2
    check = rec["autotune_cross_check"]
    if shape == "train_4k":
        assert {"param_gather.inner", "param_gather.outer", "grad_rs.inner", "grad_rs.outer",
                "hop2"} <= set(check)
    else:
        assert {"param_gather.inner", "param_gather.outer"} <= set(check)
    for stage, c in check.items():
        assert c["measured_count"] == c["predicted_count"], stage
        assert c["measured_wire_bytes"] == pytest.approx(c["predicted_wire_bytes"],
                                                         rel=1e-12), stage
    if shape == "train_4k":
        bd = rec["boundary"]
        assert bd["bucket_count_match"] and bd["measured"]["hop2_ops"] == bd["n_hop2_collectives"]
    # the planner at the same arguments
    model = build_model(cfg, tp=2)
    topo = D.production_topology(WORLD, P, tp=2)
    gp, sp = policies_from_config(mcfg)
    lb = gb // micro // topo.data_parallel_size
    if shape == "decode_32k":
        want = M.predict_footprint(model, topo, gp, sp, mode="serve", kv_pages_tokens=lb * seq,
                                   kv_dtype="bf16", decode_batch=lb, decode_ctx=seq)
    else:
        want = M.predict_footprint(model, topo, gp, sp, micro_steps=micro, local_batch=lb,
                                   seq=seq, boundary=mcfg.boundary_schedule,
                                   hop2_bucket_mb=mcfg.hop2_bucket_mb, mlstm_chunk=chunk)
    got = rec["memplan"]
    assert got["total_bytes"] == want.total_bytes and got["moment"] == want.moment
    assert got["components"] == want.components and got["local_batch"] == lb
    assert rec["stats"]["dot_flops"] > 0 and rec["stats"]["hbm_bytes"] > 0
    assert rec["stats"]["ici_wire_bytes"] + rec["stats"]["dci_wire_bytes"] > 0
    rows = A.build_table(art=tmp_path)
    assert [(r["arch"], r["shape"], r["mesh"], r["p"]) for r in rows] == [
        (cfg.name, shape, "8x2", P)]
    assert rows[0]["compute_s"] == rec["stats"]["dot_flops"] / LM.H100_P5.peak_flops


def test_planner_only_cell_says_why(tmp_path, one_thread):
    """An xLSTM train cell at the shape's 4,096 tokens is priced by the
    planner and predict_traffic alone, its reason in the record; the table
    lists it without terms."""
    cfg = smoke_variant(get_config("xlstm-125m"))
    rec = D.run_cell("xlstm-125m", "train_4k", False, MiCSConfig(micro_steps=4), cfg=cfg,
                     out_dir=tmp_path / "dryrun", device="cpu", world=WORLD, seq=64, global_batch=32)
    assert rec["ran"] == "planner" and rec["stats"] is None and "timestep" in rec["reason"]
    assert rec["predicted_traffic"]["hop2"]["count"] > 0
    assert rec["memplan"]["total_bytes"] > 0
    (row,) = A.build_table(art=tmp_path)
    assert row["note"] == rec["reason"] and "compute_s" not in row


def test_dot_flops_against_the_reference(tmp_path, one_thread):
    """The smoke llama train cell's counted products (rank 0, the port's
    plain kernels on the CPU) against the reference's HLO statistics of the
    same cell: equal within 1% once the port's extra product is taken off —
    its attention backward recomputes the scores q k^T (2 dh a (query, key)
    pair and head) where XLA's autodiff reuses the forward's."""
    ref = run_harness(HARNESS, timeout=600)
    from dryrun_flops_harness import SMOKE_TRAIN as C

    cfg = smoke_variant(get_config(C["arch"]))
    world = (1, C["repl"] * C["shard"], C["model"])
    mcfg = MiCSConfig(micro_steps=C["micro_steps"], gather_dtype=torch.float32, prefetch=False)
    rec = D.run_cell(C["arch"], "train_4k", False, mcfg, out_dir=tmp_path, cfg=cfg,
                     device="cpu", world=world, seq=C["seq"], global_batch=C["global_batch"],
                     partition_size=C["shard"], ran="storage")
    rows = C["global_batch"] // (C["repl"] * C["shard"])
    heads = cfg.n_heads // C["model"]
    recompute = 2 * cfg.resolved_head_dim * C["seq"] ** 2 * heads * cfg.n_layers * rows
    port = rec["stats"]["dot_flops"]
    assert port - recompute == pytest.approx(ref["dot_flops"], rel=0.01)
    assert port != ref["dot_flops"]


@pytest.mark.parametrize("arch,shape,seq,gb", [("llama3.2-1b", "train_4k", 32, 32),
                                               ("llama3.2-1b", "decode_32k", 64, 16),
                                               ("bert-10b", "train_4k", 32, 32),
                                               ("bert-10b", "decode_32k", 64, 16)])
def test_dense_dot_flops_are_the_configs(arch, shape, seq, gb, tmp_path, one_thread):
    """A dense smoke cell's counted products (rank 0 of the 16-rank fake
    world at tp 2, on the CPU) equal ``analysis.dense_rank_dot_flops`` over
    every (query, key) pair, as the plain attention computes them: the
    rank's matrices with its shared KV head whole, the recompute without
    the MLP's down projection, and attention at 18 dh a pair (decode 2 and
    4 dh); with the masks, the attention is what the flash kernels report."""
    cfg = smoke_variant(get_config(arch))
    micro = D.TRAIN_MICRO_STEPS if shape == "train_4k" else 1
    rec = D.run_cell(arch, shape, False, MiCSConfig(micro_steps=micro), cfg=cfg,
                     out_dir=tmp_path, device="cpu", world=WORLD, seq=seq, global_batch=gb,
                     partition_size=P, ran="storage")
    rows = max(rec["memplan"]["local_batch"], 1)
    want = A.dense_rank_dot_flops(cfg, tp=2, kind=rec["kind"], rows=rows, seq=seq,
                                  micro_steps=micro, all_pairs=True)
    assert rec["stats"]["dot_flops"] == want["total"]
    assert rec["stats"]["kernel_dot_flops"] == 0  # no kernel launches on the CPU
    masked = A.dense_rank_dot_flops(cfg, tp=2, kind=rec["kind"], rows=rows, seq=seq,
                                    micro_steps=micro)
    assert masked["matmul"] == want["matmul"]
    # the causal mask hides pairs in a train step, none from the last position
    assert (masked["attention"] < want["attention"]) == (shape == "train_4k")
    b, hkv, g, dh = rows, 1, cfg.n_heads // 2, cfg.resolved_head_dim
    q = torch.empty(b, seq if shape == "train_4k" else 1, hkv, g, dh)
    k = torch.empty(b, seq, hkv, dh)
    offset = 0 if shape == "train_4k" else seq - 1
    fwd, _ = FA.attention_work(q, k, kv_len=seq, causal=True, window=cfg.window, q_offset=offset)
    bwd, _ = FA.attention_work(q, k, kv_len=seq, causal=True, window=cfg.window, q_offset=offset,
                               backward=True)
    per_layer = 2 * fwd + bwd if shape == "train_4k" else fwd
    assert masked["attention"] == per_layer * micro * cfg.n_layers


@pytest.mark.parametrize("causal,window,tq,tk,q_offset", [
    (False, 0, 24, 40, 0), (True, 0, 32, 32, 0), (True, 8, 32, 32, 0), (True, 0, 8, 40, 32)])
def test_kernel_reports_match_the_plain_products(causal, window, tq, tk, q_offset):
    """Flash attention's reported products (``attention_work``, what its
    wrapper reports a launch) against ``FlopCounterMode`` over its plain
    version, which computes every (query, key) product: equal without a
    mask, and equal to the masked share of them with one; the bytes are
    q and o, and the keys and values read once."""
    from torch.utils.flop_counter import FlopCounterMode

    b, hkv, g, dh = 2, 2, 3, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, tq, hkv, g, dh, generator=gen)
    k = torch.randn(b, tk, hkv, dh, generator=gen)
    v = torch.randn(b, tk, hkv, dh, generator=gen)
    with FlopCounterMode(display=False) as fc:
        FA.attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    flops, nbytes = FA.attention_work(q, k, kv_len=tk, causal=causal, window=window,
                                      q_offset=q_offset)
    allowed = FA.mask_bias(tq, tk, causal=causal, window=window, q_offset=q_offset,
                           kv_valid_len=None, device="cpu") == 0
    assert flops == fc.get_total_flops() * int(allowed.sum()) / allowed.numel()
    assert nbytes == (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bflops, bbytes = FA.attention_work(q, k, kv_len=tk, causal=causal, window=window,
                                       q_offset=q_offset, backward=True)
    assert bflops == flops * 10 / 4
    assert bbytes == (4 * q.numel() + 4 * k.numel()) * 4 + b * hkv * g * tq * 4


def test_fake_and_storage_count_the_same(tmp_path, one_thread):
    """The same smoke cell on fake tensors counts the products, bytes and
    census of the run on real ones."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    recs = {ran: D.run_cell("llama3.2-1b", "decode_32k", False, MiCSConfig(), cfg=cfg,
                            out_dir=tmp_path / ran, device="cpu", world=WORLD, seq=64,
                            global_batch=16, partition_size=P, ran=ran)
            for ran in ("storage", "fake")}
    s, f = recs["storage"]["stats"], recs["fake"]["stats"]
    for key in ("dot_flops", "hbm_bytes", "ici_wire_bytes", "dci_wire_bytes", "by_stage"):
        assert s[key] == f[key], key
