"""The ``wgmma256`` flash backward's plan on the CPU: ``plan_dkdv_pieces``
cuts each key tile's rows into pieces that cover every (key tile, row
tile) pair the masks allow exactly once, in a fixed order, longest first,
none far above the mean; and the plain mirror of its algorithm (partials by
piece, folded in slot order, ``flash_attention_bwd_pieces_plain``) against
``flash_attention_bwd_plain`` and ``jax.vjp`` of the JAX package's
``repro.models.layers.attention``.  The CUDA kernel is held to the plain
version on the card (``tests/test_torch_bwd_routes.py``, ``gpu``;
``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402

KEYS, ROWS = FA.WGMMA256_KEYS, FA.WGMMA256_ROWS
# A piece may exceed the mean piece by this share of it and one tile: the
# plan's pieces are at most its size and a key tile's differ by one tile,
# but key tiles shorter than the size stay whole and pull the mean down.
MEAN_MARGIN = 0.25

PLAN_CASES = {
    # id: (b, hkv, tq, tk, g, causal, window, q_offset, kv_valid_len, sms)
    "recurrentgemma-train": (2, 1, 2048, 2048, 10, True, 2048, 0, None, 132),
    "window-64": (2, 1, 512, 512, 10, True, 64, 0, None, 132),
    "ragged-T300": (2, 1, 300, 300, 10, True, 0, 0, None, 132),
    "kv-valid-150": (2, 1, 128, 256, 10, True, 0, 64, 150, 132),
    "hkv2-g4": (1, 2, 77, 77, 4, True, 0, 0, None, 132),
    "full-few-sms": (1, 1, 100, 100, 10, False, 0, 0, None, 8),
}


def _plan(case):
    b, hkv, tq, tk, g, causal, window, q_offset, kvl, sms = PLAN_CASES[case]
    kv_len = tk if kvl is None else min(tk, kvl)
    return FA.plan_dkdv_pieces(b, hkv, tq, tk, g, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len, sms=sms)


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_pieces_cover_each_allowed_pair_once(case):
    b, hkv, tq, tk, g, causal, window, q_offset, kvl, sms = PLAN_CASES[case]
    pieces, tiles = _plan(case)
    ktiles = -(-tk // KEYS)
    assert len(tiles) == b * hkv * ktiles
    assert sorted(pc[3] for pc in pieces) == list(range(len(pieces)))
    allowed = (FA.mask_bias(tq, tk, causal=causal, window=window, q_offset=q_offset,
                            kv_valid_len=kvl, device="cpu") == 0).repeat_interleave(g, dim=0)
    by_slot = {pc[3]: pc for pc in pieces}
    for kid, (first, count) in enumerate(tiles):
        kt = kid % ktiles
        # this key tile's pieces in slot order: its rows, ascending, each row
        # tile once (pieces start on a tile of the range and never overlap)
        seen = np.zeros(tq * g, dtype=int)
        end = None
        for slot in range(first, first + count):
            key, r0, r1, _ = by_slot[slot]
            assert key == kid and r0 < r1
            assert end is None or r0 == end
            end = r1
            seen[r0:r1] += 1
        if count:
            assert (by_slot[first][1] - FA.rows_seeing(
                kt * KEYS, min(kt * KEYS + KEYS, tk if kvl is None else min(tk, kvl)), tq, g,
                causal=causal, window=window, q_offset=q_offset)[0]) % ROWS == 0
        assert seen.max(initial=0) <= 1
        rows_needed = allowed[:, kt * KEYS:(kt + 1) * KEYS].any(dim=1).numpy()
        assert (seen[rows_needed] == 1).all(), f"key tile {kid}: an allowed row is not covered"


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_pieces_are_balanced_and_in_a_fixed_order(case):
    pieces, _ = _plan(case)
    FA.plan_dkdv_pieces.cache_clear()
    assert _plan(case)[0] == pieces                      # the same plan on every call
    lens = [-(-(r1 - r0) // ROWS) for _, r0, r1, _ in pieces]
    rows = [r1 - r0 for _, r0, r1, _ in pieces]
    assert rows == sorted(rows, reverse=True)            # longest first
    same = [pc[3] for pc in pieces]                      # ties in slot order
    assert all(same[i] < same[i + 1] for i in range(len(rows) - 1) if rows[i] == rows[i + 1])
    mean = sum(lens) / len(lens)
    assert max(lens) <= (1 + MEAN_MARGIN) * mean + 1, (max(lens), mean)


def test_train_shape_plan():
    """recurrentgemma-2b's train shape: 10,560 row tiles over 64 key tiles
    (320 down to 10 each) in 288 pieces of at most 40, about two waves of
    132 blocks; the fp32 partials take 288 x 128 KB."""
    pieces, tiles = _plan("recurrentgemma-train")
    lens = [-(-(r1 - r0) // ROWS) for _, r0, r1, _ in pieces]
    assert (len(pieces), sum(lens), max(lens)) == (288, 10560, 40)
    assert [t[1] for t in tiles[:2]] == [8, 8] and tiles[31][1] == 1


def _pair(arr, dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


MIRROR_CASES = {
    # id: (b, T, hkv, g, dh, causal, window, sms): few SMs cut key tiles into pieces
    "mqa-g10-dh256-window": (1, 80, 1, 10, 256, True, 24, 2),
    "g3-causal": (2, 150, 1, 3, 32, True, 0, 4),
    "hkv2-g4-full": (1, 70, 2, 4, 16, False, 0, 3),
}


@jax.jit
def _attention_vjp(q, k, v, do):
    return jax.vjp(lambda q_, k_, v_: JL.attention(q_, k_, v_, causal=True, window=24),
                   q, k, v)[1](do)


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_pieces_mirror_matches_plain_fp32(case):
    """Partials by piece, folded in slot order, equal the one-pass plain
    backward in fp32 up to the order of the sums, and (the recurrentgemma
    heads' case) ``jax.vjp`` of the reference's attention."""
    b, t, hkv, g, dh, causal, window, sms = MIRROR_CASES[case]
    rng = np.random.default_rng(7)
    qj, q = _pair(rng.normal(size=(b, t, hkv, g, dh)), "fp32")
    kj, k = _pair(rng.normal(size=(b, t, hkv, dh)), "fp32")
    vj, v = _pair(rng.normal(size=(b, t, hkv, dh)), "fp32")
    dj, do = _pair(rng.normal(size=(b, t, hkv, g, dh)), "fp32")
    kw = dict(causal=causal, window=window)
    o, lse = FA.attention_plain_lse(q, k, v, **kw)
    pieces, tiles = FA.plan_dkdv_pieces(b, hkv, t, t, g, q_offset=0, kv_len=t, sms=sms, **kw)
    assert max(n for _, n in tiles) > 1                  # some key tile is cut
    got = FA.flash_attention_bwd_pieces_plain(q, k, v, o, lse, do, sms=sms, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for a, w, what in zip(got, want, ("dq", "dk", "dv")):
        err, scale = (a - w).abs().max().item(), w.abs().max().item()
        assert err <= 1e-5 * scale, f"{what}: max |err| {err} > 1e-5 x {scale}"
    if case == "mqa-g10-dh256-window":
        for a, w, what in zip(got, _attention_vjp(qj, kj, vj, dj), ("dq", "dk", "dv")):
            ref = np.asarray(w)
            err, scale = float(np.abs(a.numpy() - ref).max()), float(np.abs(ref).max())
            assert err <= 1e-5 * scale, f"{what} vs JAX: max |err| {err} > 1e-5 x {scale}"
