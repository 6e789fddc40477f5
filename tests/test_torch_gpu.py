"""The port's CUDA kernels against their plain PyTorch versions, and the
training and serving paths that launch them, on a card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when
torch finds no CUDA card.  Run them on a machine with one:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math

import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import fingerprint as fp
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

TOL32 = dict(rtol=1e-5, atol=1e-5)   # split-KV order vs one softmax
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)  # bf16 output rounding


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _decode_inputs(dev, B, S, H, Hkv, D, dtype, ring, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    if ring:
        q_pos = torch.randint(S // 2, 2 * S, (B,), generator=gen, device=dev)
        k_pos = torch.randint(-1, 2 * S, (B, S), generator=gen, device=dev)
        k_pos[:, 0] = q_pos
    else:
        q_pos = torch.tensor([(S // 2, S - 1, S // 3)[b % 3]
                              for b in range(B)], device=dev)
        k_pos = torch.arange(S, device=dev)[None].repeat(B, 1)
        k_pos = torch.where(k_pos <= q_pos[:, None], k_pos, -1)
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 2048, 8, 4, 32),
                                         (2, 256, 8, 2, 64),
                                         (1, 128, 4, 4, 32),
                                         (3, 1000, 12, 3, 48),
                                         # launch.serve: smollm_360m
                                         (8, 128, 15, 5, 64),
                                         # recurrentgemma_2b: MQA, D 256
                                         (8, 128, 10, 1, 256),
                                         (2, 2048, 10, 1, 256),
                                         # launch.serve, the dense family:
                                         # codeqwen (MHA, D 128), chatglm3
                                         # (g 16), gemma3 (D 256, g 2), and
                                         # gemma3's 1024-slot ring and
                                         # 1280-slot global cache
                                         (8, 128, 32, 32, 128),
                                         (8, 128, 32, 2, 128),
                                         (8, 128, 8, 4, 256),
                                         (2, 1024, 8, 4, 256),
                                         (2, 1280, 8, 4, 256),
                                         # granite_moe_1b_a400m's serve
                                         # shape (16 heads over 8, D 64)
                                         (8, 128, 16, 8, 64),
                                         # whisper_large_v3 (MHA, 20
                                         # heads, D 64) and qwen2_vl_72b
                                         # (64 heads over 8, D 128, a
                                         # 320-slot cache)
                                         (8, 128, 20, 20, 64),
                                         (8, 320, 64, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, B, S, H, Hkv, D, dtype, ring):
    q, k, v, qp, kp = _decode_inputs(cuda, B, S, H, Hkv, D, dtype, ring)
    before = da.LAUNCHES
    got = da.decode_attention(q, k, v, qp, kp)
    again = da.decode_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 2
    want = ref.decode_attention(q, k, v, q_pos=qp, k_pos=kp)
    tol = TOL32 if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("C,R", [(1, 8192), (3, 77), (2, 1), (1, 300)])
def test_fingerprint_kernel_bit_identical(cuda, C, R):
    gen = torch.Generator(device=cuda).manual_seed(C * R)
    words = torch.randint(-2 ** 31, 2 ** 31, (C, R, 128), generator=gen,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    got = fp.fingerprint_lanes(words)
    assert torch.equal(got, fp.fingerprint_lanes_ref(words))
    assert torch.equal(got.cpu(), fp.fingerprint_lanes_ref(words.cpu()))


def test_fingerprint_kernel_unaligned_view(cuda):
    words = torch.arange(3 * 128 + 1, dtype=torch.int32, device=cuda)[1:]
    words = words.reshape(1, 3, 128)  # 4-byte offset: the wrapper copies
    assert torch.equal(fp.fingerprint_lanes(words),
                       fp.fingerprint_lanes_ref(words))


# the fold's 4 MiB chunk, a small leaf (xlstm_350m's norm vectors), a
# 210 MB leaf of 50 chunks, a chunk past 256 runs, and ragged runs
FP_SHAPES = [(1, 8192), (1, 8), (50, 8192), (1, 20000), (7, 33)]


@pytest.mark.parametrize("C,R", FP_SHAPES)
def test_fingerprint_kernel_one_launch_shapes(cuda, C, R):
    gen = torch.Generator(device=cuda).manual_seed(C + R)
    words = torch.randint(-2 ** 31, 2 ** 31, (C, R, 128), generator=gen,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    before = fp.LAUNCHES
    got = fp.fingerprint_lanes(words)
    again = fp.fingerprint_lanes(words)
    assert fp.LAUNCHES == before + 2
    want = fp.fingerprint_lanes_ref(words)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_fingerprint_every_plan_gives_the_same_bits(cuda):
    """Any cut of the lanes into slices and of the rows into runs (clusters
    of 1 to 16 CTAs) gives the same lanes (sums mod 2^32), eager or
    replayed in a CUDA graph."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    words = torch.randint(-2 ** 31, 2 ** 31, (3, 8192, 128), generator=gen,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    want = fp.fingerprint_lanes_ref(words)
    plans = [fp.FingerprintPlan(-(-8192 // runs), runs, pieces)
             for runs in (1, 2, 3, 8, 12, 16) for pieces in (1, 2, 4, 32)]
    # runs longer than needed: the last ones empty
    plans += [fp.FingerprintPlan(1000, 16, 2), fp.FingerprintPlan(8192, 2, 8)]
    for plan in plans:
        for _ in range(3):
            assert torch.equal(fp.fingerprint_lanes(words, plan=plan), want)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fp.fingerprint_lanes(words)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        outs = [fp.fingerprint_lanes(words) for _ in range(4)]
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)


def test_fingerprint_kernel_one_device_entry_a_call(cuda):
    """One kernel a call: no memset of the output before it."""
    from torch.profiler import ProfilerActivity, profile

    words = torch.zeros((1, 8192, 128), dtype=torch.int32, device=cuda)
    fp.fingerprint_lanes(words)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fp.fingerprint_lanes(words)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")}
    assert sum(counts.values()) == 5, counts
    assert all("fingerprint_lanes_kernel" in k for k in counts), counts


def test_fingerprint_kernel_rejects_a_plan_that_misses_rows(cuda):
    words = torch.zeros((1, 100, 128), dtype=torch.int32, device=cuda)
    for plan in (fp.FingerprintPlan(32, 3, 32),  # rows 96..99 missed
                 fp.FingerprintPlan(4, 32, 32),  # a cluster above 16
                 fp.FingerprintPlan(100, 1, 3)):  # slices do not divide
        with pytest.raises(RuntimeError, match="fingerprint_lanes"):
            fp.fingerprint_lanes(words, plan=plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.bool])
def test_chunk_fingerprint_card_equals_host(cuda, dtype):
    x = torch.randn((4, 1, 2048, 4, 32), device=cuda)
    x = x > 0 if dtype == torch.bool else x.to(dtype)
    for chunk in (4 * 1024 * 1024, 64 * 1024):
        assert torch.equal(ops.chunk_fingerprint(x, chunk).cpu(),
                           ops.chunk_fingerprint(x.cpu(), chunk))


def test_consumer_on_card_matches_cpu(cuda):
    from repro_torch import configs
    from repro_torch.broker.broker import Message
    from repro_torch.core.consumer import StatefulConsumer
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map

    cfg = configs.get_config("paper_consumer")
    params = T.init_lm(cfg, seed=0, device=cuda)
    on_card = StatefulConsumer(cfg, params, 256)
    on_host = StatefulConsumer(cfg, tree_map(lambda t: t.cpu(), params), 256)
    msgs = [Message(i, {"token": (7 * i) % cfg.vocab_size}, 0.0)
            for i in range(40)]
    on_card.replay_sequential(msgs)
    on_host.replay_sequential(msgs)
    assert on_card.state_equal(on_host, exact=False)
    # replay from a snapshot is bit-exact on the card
    snap = StatefulConsumer(cfg, params, 256)
    snap.replay_sequential(msgs[:15])
    tree = tree_map(lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor)
                    else x, snap.state_tree())
    target = StatefulConsumer(cfg, params, 256)
    target.load_state(tree)
    target.replay_sequential(msgs[15:])
    for a, b in zip(leaves(target.cache), leaves(on_card.cache)):
        assert torch.equal(a, b)


# -- fused codec kernels -----------------------------------------------------

def _codec_pair(dev, C, R, seed):
    """float32 words [C, R, 128] and a parent with a dirty stripe."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cur = torch.randn((C, R, 128), generator=gen, device=dev)
    par = cur.clone()
    lo = R // 3
    hi = min(R, lo + max(1, R // 8))
    par[:, lo:hi] += torch.randn((C, hi - lo, 128), generator=gen, device=dev)
    return cur.view(torch.int32), par.view(torch.int32)


def _edge_pair(dev):
    from repro_torch.kernels.codec import edge_blocks

    cur, par = edge_blocks()
    return (torch.from_numpy(cur).view(torch.int32).reshape(1, -1, 128).to(dev),
            torch.from_numpy(par).view(torch.int32).reshape(1, -1, 128).to(dev))


# the fold's [1, 8192, 128] (one 4 MiB chunk), the serving engine's
# slot-aligned grid (~[1024, 4, 128]), the trainer pre-copy's 64 KiB grid
# ([C, 128, 128]) and ragged odd-R shapes
CODEC_SHAPES = [(1, 8192), (1024, 4), (32, 128), (3, 77), (2, 1), (5, 129)]


@pytest.mark.parametrize("C,R", CODEC_SHAPES)
def test_xor_fp_kernel_bit_identical(cuda, C, R):
    from repro_torch.kernels import codec as ck

    cur, par = _codec_pair(cuda, C, R, seed=C + R)
    before = ck.LAUNCHES["xor_fp_lanes"]
    lanes, xor = ck.xor_fp_lanes(cur, par)
    lanes2, xor2 = ck.xor_fp_lanes(cur, par)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["xor_fp_lanes"] == before + 2
    want_lanes, want_xor = ck.xor_fp_ref(cur, par)
    assert torch.equal(lanes, want_lanes) and torch.equal(xor, want_xor)
    assert torch.equal(lanes, lanes2) and torch.equal(xor, xor2)
    assert torch.equal(lanes, fp.fingerprint_lanes(cur))
    cpu = ck.xor_fp_ref(cur.cpu(), par.cpu())
    assert torch.equal(lanes.cpu(), cpu[0]) and torch.equal(xor.cpu(), cpu[1])


@pytest.mark.parametrize("C,R", CODEC_SHAPES + [("edge", None)])
def test_int8_fp_kernel_bit_identical(cuda, C, R):
    from repro_torch.kernels import codec as ck

    if C == "edge":
        cur, par = _edge_pair(cuda)
    else:
        cur, par = _codec_pair(cuda, C, R, seed=3 * R)
    before = ck.LAUNCHES["int8_fp_lanes"]
    got = ck.int8_fp_lanes(cur, par)
    again = ck.int8_fp_lanes(cur, par)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["int8_fp_lanes"] == before + 2
    want = ck.int8_fp_ref(cur, par)
    cpu = ck.int8_fp_ref(cur.cpu(), par.cpu())
    for g, a, w, c in zip(got, again, want, cpu):
        assert g.dtype == w.dtype and g.shape == w.shape
        bits = (lambda t: t.view(torch.int32)) if g.is_floating_point() \
            else (lambda t: t)
        assert torch.equal(bits(g), bits(a))
        assert torch.equal(bits(g), bits(w))
        assert torch.equal(bits(g).cpu(), bits(c))


# CODEC_SHAPES, a 4 MiB trainer leaf of 64 chunks, an 8-chunk trainer
# leaf and the trainer's smallest leaf
PLAN_SHAPES = CODEC_SHAPES + [(64, 128), (8, 128), (1, 2)]


@pytest.mark.parametrize("C,R", PLAN_SHAPES)
@pytest.mark.parametrize("kind", ["xor", "int8"])
def test_codec_every_plan_gives_the_same_bits(cuda, kind, C, R):
    """Every plan ``tools/profile_torch_codec.py --sweep`` times (both
    routes of the int8 kernel: a chunk's runs one cluster, and q and scale
    then the fingerprint kernel; slices, runs and chunk groups) gives the
    plain version's bits, twice, and counts one launch a call."""
    from repro_torch.kernels import codec as ck
    from tools.profile_torch_codec import sweep_plans

    cur, par = _codec_pair(cuda, C, R, seed=7 * C + R)
    name = f"{kind}_fp_lanes"
    fn = getattr(ck, name)
    want = (ck.xor_fp_ref if kind == "xor" else ck.int8_fp_ref)(cur, par)
    plans = sweep_plans(C, R, kind)
    assert {p.route for p in plans} == (
        {"cluster"} if kind == "xor" else set(ck.ROUTES))
    for plan in plans:
        before = ck.LAUNCHES[name]
        got, again = fn(cur, par, plan=plan), fn(cur, par, plan=plan)
        torch.cuda.synchronize()
        assert ck.LAUNCHES[name] == before + 2
        for g, a, w in zip(got, again, want):
            bits = (lambda t: t.view(torch.int32)) if g.is_floating_point() \
                else (lambda t: t)
            assert g.dtype == w.dtype and g.shape == w.shape, plan
            assert torch.equal(bits(g), bits(w)), plan
            assert torch.equal(bits(g), bits(a)), plan


@pytest.mark.parametrize("C,R", [(1, 8192), (64, 128), (1024, 4), (1, 8),
                                 (3, 77)])
@pytest.mark.parametrize("kind", ["xor", "int8"])
def test_codec_kernel_device_entries_a_call(cuda, kind, C, R):
    """No memset and no fill: one device entry a call on the cluster
    route, the kernel; the split route (the fold's int8 call) adds the
    fingerprint kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import codec as ck

    cur, par = _codec_pair(cuda, C, R, seed=C + R)
    fn = getattr(ck, f"{kind}_fp_lanes")
    route = ck.codec_plan(C, R, kind).route
    fn(cur, par)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn(cur, par)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")}
    kernel = f"{kind}_fp_kernel"
    assert sum(c for k, c in counts.items() if kernel in k) == 5, counts
    others = {k: c for k, c in counts.items() if kernel not in k}
    assert others == ({} if route == "cluster" else
                      {k: 5 for k in others
                       if "fingerprint_lanes_kernel" in k}), (route, counts)
    assert route == "cluster" or len(others) == 1


def test_codec_kernel_rejects_bad_plans(cuda):
    from repro_torch.kernels import codec as ck

    cur, par = _codec_pair(cuda, 1, 100, seed=1)
    for plan in (ck.CodecPlan("cluster", 32, 3, 32, 1),  # rows 96..99 missed
                 ck.CodecPlan("cluster", 4, 25, 32, 1),  # a cluster above 16
                 ck.CodecPlan("cluster", 100, 1, 3, 1),  # slices do not divide
                 ck.CodecPlan("cluster", 100, 1, 32, 3)):  # 3 chunks a CTA
        with pytest.raises(RuntimeError, match="xor_fp_lanes"):
            ck.xor_fp_lanes(cur, par, plan=plan)
    for plan in (ck.CodecPlan("cluster", 32, 3, 32, 1),  # rows 96..99 missed
                 ck.CodecPlan("cluster", 33, 4, 32, 1),  # odd rows a run
                 ck.CodecPlan("cluster", 4, 25, 32, 1)):  # a cluster above 16
        with pytest.raises(RuntimeError, match="int8_fp_lanes"):
            ck.int8_fp_lanes(cur, par, plan=plan)
    with pytest.raises(ValueError, match="cluster"):
        ck.xor_fp_lanes(cur, par, plan=ck.CodecPlan("split", 4, 25, 32, 1))
    with pytest.raises(ValueError, match="whole rows"):
        ck.int8_fp_lanes(cur, par, plan=ck.CodecPlan("cluster", 100, 1, 8, 1))


@pytest.mark.parametrize("codec", ["xor_rle", "int8"])
def test_fused_leaf_encoding_card_equals_host(cuda, codec):
    import numpy as np

    from repro_torch.checkpoint.codecs import FusedLeafEncoding, get_codec
    from repro_torch.checkpoint.fingerprint import leaf_fingerprints

    cb = 64 * 1024
    gen = torch.Generator(device=cuda).manual_seed(5)
    leaf = torch.randn((4, 1, 301, 4, 32), generator=gen, device=cuda)
    parent = leaf.clone()
    parent[1, 0, 100:140] += 0.5
    parent[3] = torch.randn(parent[3].shape, generator=gen, device=cuda)
    praw = parent.cpu().numpy().tobytes()
    dt = np.dtype(np.float32)
    on_card = FusedLeafEncoding(leaf, praw, codec, dt, cb)
    on_host = FusedLeafEncoding(leaf.cpu(), praw, codec, dt, cb)
    assert np.array_equal(on_card.fps, on_host.fps)
    assert np.array_equal(on_card.fps, leaf_fingerprints(leaf.cpu(), cb))
    raw = leaf.cpu().numpy().tobytes()
    for c in range(-(-len(raw) // cb)):
        seg, pseg = raw[c * cb:(c + 1) * cb], praw[c * cb:(c + 1) * cb]
        assert on_card.blob(c) == on_host.blob(c)
        assert on_card.blob(c) == get_codec(codec).encode(seg, pseg, dt)


@pytest.mark.parametrize("kernel", ["xor_fp_lanes", "int8_fp_lanes"])
def test_codec_kernel_on_trainer_leaf_grid(cuda, kernel):
    """A real trainer leaf (the paper consumer's embedding table after six
    AdamW steps against its parent two steps earlier) on the trainer
    pre-copy's 64 KiB chunk grid: bit for bit against the plain version,
    and the card's codec blobs equal to the host codecs'."""
    import numpy as np

    from repro_torch.broker.broker import Message
    from repro_torch.checkpoint.codecs import (FusedLeafEncoding, get_codec,
                                               leaf_raw)
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import ops

    cb = 64 * 1024
    trainer = _paper_trainer(cuda)()
    for i in range(6):
        if i == 4:
            parent = trainer.state_tree()["params"]["embed"]["table"]
        trainer.process(Message(i, {"batch_id": i}, 0.0))
    leaf = trainer.params["embed"]["table"]
    praw = leaf_raw(parent)
    cur, par = ops._codec_words(leaf, praw, cb)
    assert cur.shape[1:] == (128, 128) and cur.shape[0] > 1
    fn, plain = {"xor_fp_lanes": (ck.xor_fp_lanes, ck.xor_fp_ref),
                 "int8_fp_lanes": (ck.int8_fp_lanes, ck.int8_fp_ref)}[kernel]
    for g, w in zip(fn(cur, par), plain(cur, par)):
        bits = (lambda t: t.view(torch.int32)) if g.is_floating_point() \
            else (lambda t: t)
        assert g.dtype == w.dtype and torch.equal(bits(g), bits(w))
    codec = "xor_rle" if kernel == "xor_fp_lanes" else "int8"
    dt = np.dtype(np.float32)
    enc = FusedLeafEncoding(leaf, praw, codec, dt, cb)
    raw = leaf_raw(leaf)
    for c in range(-(-len(raw) // cb)):
        seg, pseg = raw[c * cb:(c + 1) * cb], praw[c * cb:(c + 1) * cb]
        assert enc.blob(c) == get_codec(codec).encode(seg, pseg, dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_row_without_valid_slot_is_mean_of_v(cuda, dtype):
    """A (batch row, kv head) with no valid slot: uniform softmax, the
    mean of V, as the plain version; the other rows keep their bits."""
    q, k, v, qp, kp = _decode_inputs(cuda, 3, 300, 8, 4, 32, dtype, False)
    before = da.decode_attention(q, k, v, qp, kp)
    kp_empty = kp.clone()
    kp_empty[1] = -1                       # row 1: every slot empty
    got = da.decode_attention(q, k, v, qp, kp_empty)
    want = ref.decode_attention(q, k, v, q_pos=qp, k_pos=kp_empty)
    torch.cuda.synchronize()
    tol = TOL32 if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    mean_v = v[1].float().mean(0).repeat_interleave(2, dim=0)  # [H, D]
    torch.testing.assert_close(got[1, 0].float(), mean_v, **tol)
    assert torch.equal(got[0], before[0]) and torch.equal(got[2], before[2])
    assert torch.equal(got, da.decode_attention(q, k, v, qp, kp_empty))


# -- flash attention (train / prefill) ----------------------------------------

def _flash_inputs(dev, B, Sq, Sk, H, Hkv, D, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
    return q, k, v


FLASH_CASES = [  # (B, Sq, Sk, H, Hkv, D, causal, window)
    # tests/test_kernels.py's sweep shapes, causal, window 0 and 64
    *[(B, S, S, H, Hkv, D, True, w)
      for B, S, H, Hkv, D in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                              (1, 256, 4, 1, 128), (2, 128, 6, 3, 32)]
      for w in (0, 64)],
    (8, 128, 128, 15, 5, 64, True, 0),   # smollm_360m train
    (8, 128, 128, 8, 4, 32, True, 0),    # paper_consumer train
    (8, 32, 32, 15, 5, 64, True, 0),     # smollm_360m prefill
    (2, 256, 256, 4, 2, 64, True, 40),   # rows whose first tile is masked
    (2, 100, 100, 6, 2, 48, True, 0),    # ragged
    (2, 77, 77, 3, 1, 20, True, 0),      # smollm smoke head_dim
    (2, 128, 48, 4, 2, 16, True, 16),    # rows with no valid key
    (2, 96, 96, 4, 4, 32, False, 0),     # no mask
    # recurrentgemma_2b's local layers: MQA (10 heads over 1), D 256,
    # window 2048; the 2304-token prompt is where the window bites
    (8, 32, 32, 10, 1, 256, True, 2048),
    (2, 2304, 2304, 10, 1, 256, True, 2048),
    (2, 100, 100, 10, 1, 256, True, 40),
    (2, 72, 40, 4, 2, 256, True, 16),    # D 256, rows with no valid key
    (1, 77, 77, 3, 1, 200, True, 0),     # 128 < D < 256
    # the dense family's prefills: codeqwen (MHA, D 128), chatglm3 (32
    # heads over 2), gemma3's local (window 1024) and global layers at
    # launch.serve's 8 x 32 and at a 1152-token prompt past the window
    (8, 32, 32, 32, 32, 128, True, 0),
    (8, 32, 32, 32, 2, 128, True, 0),
    (8, 32, 32, 8, 4, 256, True, 1024),
    (2, 1152, 1152, 8, 4, 256, True, 1024),
    (2, 1152, 1152, 8, 4, 256, True, 0),
    (8, 32, 32, 16, 8, 64, True, 0),     # granite_moe_1b_a400m prefill
    # whisper_large_v3 (MHA, 20 heads, D 64): the encoder over 1500 frames
    # (non-causal; 1500 = 23 * 64 + 28, a ragged last kv tile), the
    # decoder's cross-attention over them at the prefill (Sq 32) and at a
    # decode step (Sq 1), and its causal self-attention; qwen2_vl_72b's
    # 288-token prefill (64 heads over 8, D 128)
    (8, 1500, 1500, 20, 20, 64, False, 0),
    (8, 32, 1500, 20, 20, 64, False, 0),
    (8, 1, 1500, 20, 20, 64, False, 0),
    (8, 32, 32, 20, 20, 64, True, 0),
    (8, 288, 288, 64, 8, 128, True, 0),
    # train-whisper's 8 x 128 decoder: causal self-attention and the
    # cross-attention over the 1500 frames
    (8, 128, 128, 20, 20, 64, True, 0),
    (8, 128, 1500, 20, 20, 64, False, 0),
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, Hkv, D, causal,
                                    window, dtype):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Hkv, D, dtype)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    want = ref.naive_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    tol = TOL32 if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 20),
                                     (torch.float32, 64),
                                     (torch.float32, 256)])
def test_flash_route_counter(cuda, dtype, D):
    """bf16 with D % 16 == 0 launches the bf16 wgmma kernel; float32, and
    bf16 with another D, the tf32x3 one: LAUNCHES counts both,
    WGMMA_LAUNCHES the first and TF32X3_LAUNCHES the second."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs(cuda, 2, 80, 80, 4, 2, D, dtype)
    total, wgmma, tf32x3 = (fa.LAUNCHES, fa.WGMMA_LAUNCHES,
                            fa.TF32X3_LAUNCHES)
    fa.flash_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    on_wgmma = dtype == torch.bfloat16 and D % 16 == 0
    assert fa.route(dtype, D) == ("wgmma" if on_wgmma else "tf32x3")
    assert fa.LAUNCHES == total + 1
    assert fa.WGMMA_LAUNCHES == wgmma + on_wgmma
    assert fa.TF32X3_LAUNCHES == tf32x3 + (not on_wgmma)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (2, 100, 100, 6, 2, 64, True, 0),     # Sq not a multiple of 64
    (3, 33, 33, 10, 1, 256, True, 2048),  # the serving prefill's ragged tile
    (2, 77, 150, 4, 2, 128, True, 64),    # Sq < Sk, ragged both
    (1, 130, 130, 2, 1, 32, False, 0),    # no mask, 2 rows in the last tile
    (2, 200, 72, 4, 2, 48, True, 16),     # rows with no valid key
])
def test_flash_wgmma_route_ragged_rows(cuda, B, Sq, Sk, H, Hkv, D, causal,
                                       window):
    """The tensor-core route with query rows past Sq in the last 64-row
    tile: they are masked at the store, and nothing else moves."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Hkv, D, torch.bfloat16,
                            seed=5)
    wgmma = fa.WGMMA_LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.WGMMA_LAUNCHES == wgmma + 1
    want = ref.naive_attention(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL_BF16)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal,
                                               window=window))


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,dtype,causal,window", [
    # D 20 (flash_f32_plan: 32-key tiles taken in turn by two warpgroups,
    # the next one loaded during the products): 100 rows (36 in the last
    # 64-row tile), 100 keys in four tiles, the last of 4 keys
    (2, 100, 100, 6, 2, 20, torch.float32, True, 0),
    # bf16 with D % 16 != 0: a last kv tile of 6 keys
    (3, 33, 70, 3, 1, 20, torch.bfloat16, False, 0),
    # D 200 (32-key tiles, one warpgroup): 77 rows, a last kv tile of 22
    # keys
    (1, 77, 150, 3, 1, 200, torch.float32, False, 0),
    # D 256 (16-key tiles, Q's hi and lo 128 KB): 130 rows, a last kv tile
    # of 6 keys, the window biting; and rows with no valid key
    (2, 130, 150, 4, 1, 256, torch.float32, True, 64),
    (2, 72, 45, 4, 2, 256, torch.float32, True, 16),
])
def test_flash_tf32x3_route_ragged_rows_and_tiles(cuda, B, Sq, Sk, H, Hkv,
                                                  D, dtype, causal, window):
    """The tf32x3 route at each of its tile plans, with query rows past Sq
    in the last 64-row tile and keys past Sk in the last kv tile: within
    the float32 tolerance of the plain version, and two launches equal."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Hkv, D, dtype, seed=9)
    assert fa.route(dtype, D) == "tf32x3"
    n = fa.TF32X3_LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.TF32X3_LAUNCHES == n + 2
    want = ref.naive_attention(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    tol = TOL32 if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


def test_flash_f32_plan_is_the_launch_codes(cuda):
    """``flash_f32_plan``, the tile plan the CPU tests check, equals the
    one the built launch code takes (its constexprs) at every head dim."""
    from repro_torch.kernels import flash_attention as fa

    for D in range(1, fa.MAX_HEAD_DIM + 1):
        assert fa.launch_f32_plan(D) == fa.flash_f32_plan(D), D


@pytest.mark.parametrize("Sq", [1, 32, 1500])
def test_flash_ragged_tile_reads_nothing_of_the_next_row(cuda, Sq):
    """Non-causal over 1500 keys (a last kv tile of 28): batch row 1 holds
    values of 1e30, and batch row 0's output is bit-equal to row 0 run
    alone, finite, on the tensor-core route (masked keys add exactly 0)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs(cuda, 2, Sq, 1500, 20, 20, 64, torch.bfloat16,
                            seed=7)
    v[1] = 1e30
    got = fa.flash_attention(q, k, v, causal=False)
    alone = fa.flash_attention(q[:1].contiguous(), k[:1].contiguous(),
                               v[:1].contiguous(), causal=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[:1], alone)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_autograd_gradients_equal_plain(cuda, window):
    q, k, v = _flash_inputs(cuda, 2, 80, 80, 4, 2, 32, torch.float32, seed=3)
    w = torch.randn(q.shape, device=cuda)
    grads = []
    for fn in (ops.attention, ref.naive_attention):
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves_, causal=True, window=window) * w).sum().backward()
        grads.append([t.grad for t in leaves_])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_cross_shape_card_equals_cpu(cuda, dtype):
    """``FlashAttention`` at a cross-attention shape (non-causal, Sq 40 over
    Sk 1500: a ragged last kv tile of 28 keys): the kernel forward and the
    plain backward on the card against the plain version's autograd on the
    CPU, the output and the gradients of q, k and v."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (t.cpu() for t in _flash_inputs(cuda, 2, 40, 1500, 4, 4, 64,
                                              dtype, seed=11))
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(12))
    outs = []
    for dev in ("cpu", cuda):
        leaves_ = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = fa.LAUNCHES
        out = ops.attention(*leaves_, causal=False)
        (out.float() * w.to(dev)).sum().backward()
        outs.append((fa.LAUNCHES - before, out.detach().cpu(),
                     [t.grad.cpu() for t in leaves_]))
    (host_n, host_o, host_g), (card_n, card_o, card_g) = outs
    assert (host_n, card_n) == (0, 1)
    tol = TOL32 if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(card_o.float(), host_o.float(), **tol)
    for a, b in zip(card_g, host_g):
        assert a.dtype == b.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs(cuda, 1, 64, 64, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="D <="):
        fa.flash_attention(*_flash_inputs(cuda, 1, 8, 8, 2, 1, 288,
                                          torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_local_ring_at_head_dim_256(cuda, dtype):
    """A local layer's 2048-slot ring past its window: empty slots, slots
    ahead of the query and slots outside the window (marked -1 as
    ``attention.attn_decode`` does), MQA with 10 heads, D 256."""
    q, k, v, qp, kp = _decode_inputs(cuda, 2, 2048, 10, 1, 256, dtype, True)
    kp = torch.where(qp[:, None] - kp < 2048, kp, -1)
    got = da.decode_attention(q, k, v, qp, kp)
    want = ref.decode_attention(q, k, v, q_pos=qp, k_pos=kp)
    torch.cuda.synchronize()
    tol = TOL32 if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, da.decode_attention(q, k, v, qp, kp))


# -- RG-LRU -------------------------------------------------------------------

RGLRU_CASES = [  # (B, S, W, dtype, h0: None, "zeros" or "random")
    (8, 32, 2560, torch.bfloat16, "zeros"),   # launch.serve's prefill
    (2, 2304, 2560, torch.bfloat16, "zeros"),  # the 2304-token prompt
    # tests/test_kernels.py's shapes
    *[(B, S, W, dt, None) for B, S, W in [(1, 64, 128), (2, 128, 256),
                                          (1, 96, 512)]
      for dt in (torch.float32, torch.bfloat16)],
    (2, 128, 256, torch.float32, "random"),
    (2, 128, 256, torch.bfloat16, "random"),
    (3, 1, 2560, torch.bfloat16, "random"),    # one step
    (2, 33, 70, torch.float32, "random"),      # W not a multiple of 64
]


def _rglru_inputs(dev, B, S, W, dtype, h0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, ga, gx = (torch.randn((B, S, W), generator=gen, device=dev).to(dtype)
                 for _ in range(3))
    a = torch.randn((W,), generator=gen, device=dev)
    h = {None: None, "zeros": torch.zeros((B, W), device=dev),
         "random": torch.randn((B, W), generator=gen, device=dev)}[h0]
    return x, a, ga, gx, h


@pytest.mark.parametrize("B,S,W,dtype,h0", RGLRU_CASES)
def test_rglru_kernel_matches_plain(cuda, B, S, W, dtype, h0):
    from repro_torch.kernels import rglru as rg

    x, a, ga, gx, h = _rglru_inputs(cuda, B, S, W, dtype, h0)
    before = rg.LAUNCHES
    got = rg.rglru(x, a, ga, gx, h)
    again = rg.rglru(x, a, ga, gx, h)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + 2
    want = ref.naive_rglru(x, a, ga, gx, h)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    # float32 state: libm ulps; h_seq in bf16: one rounding of the state
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-6))
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    assert all(torch.equal(g, w) for g, w in zip(got, again))


# chip_smoke.py's newer cases: a_t near 1 (a_param near +6), a large h0,
# and sequences ending one step either side of the long prompt's chunk
RGLRU_EDGE_CASES = [  # (B, S, W, dtype, a_mean, h0 scale)
    (2, 2304, 2560, torch.float32, 6.0, 1.0),
    (2, 2304, 2560, torch.bfloat16, 6.0, 1.0),
    (2, 2304, 2560, torch.float32, 0.0, 100.0),
    (2, 2304, 2560, torch.float32, 6.0, 100.0),
    (2, 56 * 40 + 1, 2560, torch.float32, 6.0, 1.0),
    (2, 56 * 40 - 1, 2560, torch.bfloat16, 6.0, 1.0),
]


@pytest.mark.parametrize("B,S,W,dtype,a_mean,h0_scale", RGLRU_EDGE_CASES)
def test_rglru_kernel_slow_decay_and_chunk_edges(cuda, B, S, W, dtype, a_mean,
                                                 h0_scale):
    from repro_torch.kernels import rglru as rg

    x, a, ga, gx, h = _rglru_inputs(cuda, B, S, W, dtype, "random", seed=5)
    a = a_mean + 0.5 * a if a_mean else a
    h = h0_scale * h
    got, again = rg.rglru(x, a, ga, gx, h), rg.rglru(x, a, ga, gx, h)
    want = ref.naive_rglru(x, a, ga, gx, h)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-6))
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    assert all(torch.equal(g, w) for g, w in zip(got, again))


@pytest.mark.parametrize("B,S,W", [(2, 2304, 2560), (8, 32, 2560),
                                   (2, 33, 70)])
def test_rglru_every_chunk_gives_the_same_bits(cuda, B, S, W):
    """The chunk sets only how the gates are shared out: every plan the
    kernel takes walks the same chain, so every one gives the same bits."""
    from repro_torch.kernels import rglru as rg

    x, a, ga, gx, h = _rglru_inputs(cuda, B, S, W, torch.bfloat16, "random")
    outs = []
    for u in rg.LANE_STEPS:
        chunk = 2 * rg.PRODUCERS * u
        outs.append(rg.rglru(x, a, ga, gx, h,
                             plan=rg.ScanPlan(chunk, -(-S // chunk))))
    for out in outs[1:]:
        assert all(torch.equal(o, p) for o, p in zip(out, outs[0]))


def test_rglru_autograd_gradients_equal_plain(cuda):
    x, a, ga, gx, h = _rglru_inputs(cuda, 2, 40, 96, torch.float32,
                                    "random", seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    w_seq = torch.randn(x.shape, generator=gen, device=cuda)
    w_last = torch.randn(h.shape, generator=gen, device=cuda)
    grads = []
    for fn in (ops.rglru_scan, ref.naive_rglru):
        leaves_ = [t.clone().requires_grad_() for t in (x, a, ga, gx, h)]
        seq, last = fn(*leaves_)
        ((seq * w_seq).sum() + (last * w_last).sum()).backward()
        grads.append([t.grad for t in leaves_])
    for g, p in zip(*grads):
        assert torch.equal(g, p)


def test_rglru_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import rglru as rg

    x, a, ga, gx, h = _rglru_inputs(cuda, 2, 8, 64, torch.float32, "random")
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru(x.transpose(0, 1).contiguous().transpose(0, 1), a, ga, gx)
    with pytest.raises(ValueError, match="dtypes"):
        rg.rglru(x.bfloat16(), a, ga, gx)
    with pytest.raises(ValueError, match="dtypes"):
        rg.rglru(x, a, ga, gx, h.bfloat16())
    with pytest.raises(ValueError, match="a_param"):
        rg.rglru(x, a[:32], ga, gx)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru(x.cpu(), a.cpu(), ga.cpu(), gx.cpu())


def test_serve_cli_recurrentgemma_at_full_width(cuda, capsys):
    """``launch.serve --arch recurrentgemma_2b`` at full width: per
    prefill one RG-LRU launch per RG-LRU layer (18) and one flash launch
    per local layer (8); per decode step one decode launch per local
    layer."""
    from repro_torch.kernels import decode_attention as da_
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.launch import serve

    r0, f0, d0 = rg.LAUNCHES, fa.LAUNCHES, da_.LAUNCHES
    assert serve.main(["--arch", "recurrentgemma_2b", "--requests", "2",
                       "--decode-steps", "3"]) == 0
    assert (rg.LAUNCHES - r0, fa.LAUNCHES - f0, da_.LAUNCHES - d0) == \
        (18, 8, 3 * 8)
    out = capsys.readouterr().out
    assert "[serve] prefill 32 tokens x 2 requests" in out
    assert "[serve] decoded 3 steps x 2 requests" in out


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "gemma3_4b",
                                  "chatglm3_6b"])
def test_serve_cli_dense_smoke_on_card(cuda, capsys, arch):
    """``launch.serve --arch <dense> --smoke`` on the card: one flash
    launch per layer a prefill, one decode launch per layer a step."""
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da_
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    layers = configs.get_smoke(arch).num_layers
    f0, d0 = fa.LAUNCHES, da_.LAUNCHES
    assert serve.main(["--arch", arch, "--smoke", "--requests", "3",
                       "--decode-steps", "4"]) == 0
    assert (fa.LAUNCHES - f0, da_.LAUNCHES - d0) == (layers, 4 * layers)
    assert "[serve] decoded 4 steps x 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kv_quantizer_card_equals_cpu(cuda, dtype):
    """The int8 KV cache's quantizer gives the same int8 values and bf16
    scales on the card as on the CPU (its scale a true division on
    both), and so does the dequantized product."""
    from repro_torch.models import attention

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn((8, 32, 32, 128), generator=gen, device=cuda)
         * torch.rand((8, 32, 32, 1), generator=gen, device=cuda) * 30
         ).to(dtype)
    x[0, 0] = 0  # all-zero rows take the 1e-8 clamp
    q, s = attention._quantize_kv(x)
    qc, sc = attention._quantize_kv(x.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    cache = {"k": q, "v": q, "k_scale": s, "v_scale": s}
    host = {"k": qc, "v": qc, "k_scale": sc, "v_scale": sc}
    for dt in (torch.float32, torch.bfloat16):
        k, _ = attention._dequantize_kv(cache, dt)
        assert torch.equal(k.cpu(), attention._dequantize_kv(host, dt)[0])


def _paper_trainer(dev):
    from repro_torch import configs
    from repro_torch.core.trainer_worker import TrainerWorker
    from repro_torch.data import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train import step as steplib

    cfg = configs.get_config("paper_consumer")
    tcfg = steplib.TrainStepConfig(
        remat="none", lr_peak=1e-3, warmup_steps=5, total_steps=10_000,
        opt=adamw.AdamWConfig(weight_decay=0.01))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    return lambda: TrainerWorker(cfg, tcfg, dcfg, device=dev)


def test_train_step_on_card_matches_cpu(cuda):
    from repro_torch.broker.broker import Message
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tree import leaves

    on_card, on_host = _paper_trainer(cuda)(), _paper_trainer("cpu")()
    on_host.load_state(on_card.state_tree())
    before = fa.LAUNCHES
    for i in range(3):
        on_card.process(Message(i, {"batch_id": i}, 0.0))
        on_host.process(Message(i, {"batch_id": i}, 0.0))
        torch.testing.assert_close(on_card.last_loss, on_host.last_loss,
                                   rtol=1e-5, atol=0)
    assert fa.LAUNCHES == before + 3 * on_card.cfg.num_layers
    # sum orders differ (cuBLAS and the kernel against the CPU): Adam's
    # per-entry normalization turns them into a visible part of lr on
    # entries whose gradient is near 0 (tests/test_torch_train.py); atol
    # is 5 % of the three steps' summed lr (2e-4 + 4e-4 + 6e-4)
    for a, b in zip(leaves(on_card.params), leaves(on_host.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=6e-5)


def test_trainer_replay_bit_exact_on_card(cuda):
    from repro_torch.broker.broker import Message
    from repro_torch.tree import leaves, tree_map

    make = _paper_trainer(cuda)
    a, b = make(), make()
    msgs = [Message(i, {"batch_id": i}, 0.0) for i in range(6)]
    for m in msgs:
        a.process(m)
    for m in msgs[:3]:
        b.process(m)
    snap = b.state_tree()
    b.process(msgs[3])  # the snapshot is a copy: training on is harmless
    c = make()  # restored from host arrays, as from a registry pull
    c.load_state({k: v if k == "scalars" else
                  tree_map(lambda t: t.cpu().numpy(), v)
                  for k, v in snap.items()})
    for m in msgs[3:]:
        c.process(m)
    assert c.state_equal(a)
    assert all(torch.equal(x, y) for x, y in
               zip(leaves(c.opt_state), leaves(a.opt_state)))


def test_serve_cli_on_card_runs_both_attention_kernels(cuda, capsys):
    from repro_torch.kernels import decode_attention as da_
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    f0, d0 = fa.LAUNCHES, da_.LAUNCHES
    assert serve.main(["--smoke", "--requests", "3", "--decode-steps",
                       "4"]) == 0
    assert fa.LAUNCHES > f0 and da_.LAUNCHES > d0
    assert "[serve] decoded 4 steps x 3 requests" in capsys.readouterr().out


SLSTM_CASES = [  # (B, S, H, hb, dtype)
    (8, 128, 4, 256, torch.bfloat16),   # launch.train: xlstm_350m
    (8, 128, 4, 256, torch.float32),
    *[(B, S, H, hb, dt) for B, S, H, hb in [(1, 32, 2, 16), (2, 64, 4, 32)]
      for dt in (torch.float32, torch.bfloat16)],
    (3, 7, 3, 40, torch.float32),       # hb not a multiple of 32
]


def _slstm_inputs(dev, B, S, H, hb, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn((B, S, H * hb), generator=gen, device=dev).to(dtype)
          for _ in range(4)]
    rs = [torch.randn((H, hb, hb), generator=gen, device=dev)
          * (0.02 if hb >= 256 else 0.2) for _ in range(4)]
    return xs + rs


@pytest.mark.parametrize("B,S,H,hb,dtype", SLSTM_CASES)
def test_slstm_kernel_matches_plain(cuda, B, S, H, hb, dtype):
    from repro_torch.kernels import slstm as sl

    args = _slstm_inputs(cuda, B, S, H, hb, dtype)
    before = sl.LAUNCHES
    got, again = sl.slstm(*args), sl.slstm(*args)
    torch.cuda.synchronize()
    assert sl.LAUNCHES == before + 2
    want, _ = ref.naive_slstm(*args)
    assert got.dtype == dtype
    # float32: the dot products' order; bf16: one rounding of h_seq
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


# batch groups that do not divide, one head, and hb 512 (the L2 route)
SLSTM_ROUTE_CASES = [  # (B, S, H, hb, dtype, route)
    (8, 128, 4, 256, torch.float32, "cluster"),
    (8, 128, 4, 256, torch.bfloat16, "cluster"),
    (3, 128, 4, 256, torch.bfloat16, "cluster"),
    (5, 64, 4, 256, torch.float32, "cluster"),
    (1, 128, 4, 256, torch.bfloat16, "cluster"),
    (8, 64, 1, 256, torch.float32, "cluster"),
    (2, 32, 2, 512, torch.float32, "l2"),
]


@pytest.mark.parametrize("B,S,H,hb,dtype,route", SLSTM_ROUTE_CASES)
def test_slstm_kernel_route_counter(cuda, B, S, H, hb, dtype, route):
    """Each launch counts in LAUNCHES, and a cluster-route launch in
    CLUSTER_LAUNCHES too; the route is the plan's."""
    from repro_torch.kernels import slstm as sl

    args = _slstm_inputs(cuda, B, S, H, hb, dtype, seed=7)
    assert sl.slstm_plan(B, H, hb).route == route
    total, cluster = sl.LAUNCHES, sl.CLUSTER_LAUNCHES
    got, again = sl.slstm(*args), sl.slstm(*args)
    torch.cuda.synchronize()
    assert sl.LAUNCHES == total + 2
    assert sl.CLUSTER_LAUNCHES == cluster + 2 * (route == "cluster")
    want, _ = ref.naive_slstm(*args)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=8e-3, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_routes_and_groupings_give_the_same_bits(cuda, dtype):
    """Both routes share the sums' order and the cell arithmetic, and the
    batch grouping changes neither: every plan gives the same bits."""
    from repro_torch.kernels import slstm as sl

    args = _slstm_inputs(cuda, 8, 64, 4, 256, dtype, seed=8)
    base = sl.slstm_plan(8, 4, 256)
    plans = [base._replace(rows=r) for r in (1, 2, 3, 4, 8)]
    plans.append(sl.SLSTMPlan("l2", 0, 256, 1))
    want = sl.slstm(*args)
    for plan in plans:
        assert torch.equal(sl.slstm(*args, plan=plan), want), plan


def test_slstm_autograd_gradients_equal_plain(cuda):
    args = _slstm_inputs(cuda, 2, 20, 2, 32, torch.float32, seed=3)
    w = torch.randn((2, 20, 64), generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda)
    grads = []
    for fn in (ops.slstm_scan, ref.naive_slstm):
        leaves_ = [t.clone().requires_grad_() for t in args]
        h, _ = fn(*leaves_)
        (h * w).sum().backward()
        grads.append([t.grad for t in leaves_])
    for g, p in zip(*grads):
        assert torch.equal(g, p)


def test_slstm_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import slstm as sl

    xs_rs = _slstm_inputs(cuda, 2, 8, 2, 32, torch.float32)
    xs, rs = xs_rs[:4], xs_rs[4:]
    with pytest.raises(ValueError, match="contiguous"):
        sl.slstm(xs[0].transpose(0, 1).contiguous().transpose(0, 1),
                 *xs[1:], *rs)
    with pytest.raises(ValueError, match="dtypes"):
        sl.slstm(xs[0].bfloat16(), *xs[1:], *rs)
    with pytest.raises(ValueError, match="dtypes"):
        sl.slstm(*xs, rs[0].bfloat16(), *rs[1:])
    with pytest.raises(ValueError, match="shapes"):
        sl.slstm(*xs, *(r[:, :16, :16].contiguous() for r in rs))
    with pytest.raises(ValueError, match="CUDA"):
        sl.slstm(*(t.cpu() for t in xs_rs))


MLSTM_CASES = [  # (B, S, H, D, chunk, dtype)
    (8, 128, 4, 512, 128, torch.bfloat16),  # launch.train: xlstm_350m
    (8, 128, 4, 512, 128, torch.float32),
    (2, 512, 4, 512, 128, torch.bfloat16),  # four chunks
    (2, 512, 4, 512, 128, torch.float32),
    *[(B, S, H, D, ch, dt) for B, S, H, D in [(1, 64, 2, 32), (2, 128, 4, 64)]
      for ch in (32, 64) for dt in (torch.float32, torch.bfloat16)],
    (2, 12, 3, 40, 4, torch.float32),       # D not a multiple of 32
    # the wgmma route's edges: a chunk not a multiple of 16 over two row
    # tiles, a chunk of 4, D 320 (column slices of 3 + 2 and 2 + 2 + 1
    # boxes) and D 192
    (2, 200, 2, 64, 100, torch.bfloat16),
    (1, 16, 2, 64, 4, torch.bfloat16),
    (2, 128, 3, 320, 64, torch.bfloat16),
    (1, 128, 3, 320, 128, torch.bfloat16),
    (1, 256, 2, 192, 128, torch.bfloat16),
]


def _mlstm_inputs(dev, B, S, H, D, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    ig = torch.randn((B, S, H), generator=gen, device=dev)
    fg = torch.randn((B, S, H), generator=gen, device=dev) + 3.0
    return q, k, v, ig, fg


@pytest.mark.parametrize("B,S,H,D,chunk,dtype", MLSTM_CASES)
def test_mlstm_kernel_matches_plain(cuda, B, S, H, D, chunk, dtype):
    from repro_torch.kernels import mlstm as ml

    args = _mlstm_inputs(cuda, B, S, H, D, dtype)
    before, wgmma = ml.LAUNCHES, ml.WGMMA_LAUNCHES
    got = ml.mlstm(*args, chunk=chunk)
    again = ml.mlstm(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ml.LAUNCHES == before + 2
    on_wgmma = dtype == torch.bfloat16 and D % 64 == 0
    assert ml.route(dtype, D) == ("wgmma" if on_wgmma else "float32")
    assert ml.WGMMA_LAUNCHES == wgmma + (2 if on_wgmma else 0)
    want = ref.chunkwise_mlstm(*args, chunk=chunk)
    assert got.dtype == dtype
    # relative to the largest |h|: float32 sums in another order over a
    # denominator that cancels; bf16 one rounding of h
    rel = 5e-5 if dtype == torch.float32 else 8e-3
    err = (got.float() - want.float()).abs().max()
    assert err <= rel * want.float().abs().max()
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,S,H,D,T", [(8, 128, 4, 512, 128),
                                        (2, 512, 4, 512, 128),
                                        (2, 200, 2, 64, 100),
                                        (2, 128, 3, 320, 64),
                                        (1, 16, 2, 64, 4)])
def test_mlstm_native_plan_equals_python_plan(cuda, B, S, H, D, T):
    from repro_torch.kernels import mlstm as ml

    assert ml.native_plan(B, S, H, D, T) == ml.mlstm_plan(B, S, H, D, T)


def test_mlstm_wgmma_autograd_gradients_equal_plain(cuda):
    """The wgmma route's backward is the plain version's, bit for bit."""
    from repro_torch.kernels import mlstm as ml

    args = _mlstm_inputs(cuda, 2, 128, 2, 64, torch.bfloat16, seed=5)
    w = torch.randn(args[0].shape, generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda)
    grads = []
    for fn in (lambda *a: ml.MLSTMScan.apply(*a, 64),
               lambda *a: ref.chunkwise_mlstm(*a, chunk=64)):
        leaves_ = [t.clone().requires_grad_() for t in args]
        (fn(*leaves_).float() * w).sum().backward()
        grads.append([t.grad for t in leaves_])
    for g, p in zip(*grads):
        assert torch.equal(g, p)


def test_mlstm_autograd_gradients_equal_plain(cuda):
    args = _mlstm_inputs(cuda, 2, 48, 2, 40, torch.float32, seed=3)
    w = torch.randn(args[0].shape, generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda)
    grads = []
    for fn in (ops.mlstm_scan,
               lambda *a: (ref.chunkwise_mlstm(*a, chunk=16), None)):
        leaves_ = [t.clone().requires_grad_() for t in args]
        h, _ = fn(*leaves_)
        (h * w).sum().backward()
        grads.append([t.grad for t in leaves_])
    for g, p in zip(*grads):
        assert torch.equal(g, p)


def test_mlstm_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import mlstm as ml

    q, k, v, ig, fg = _mlstm_inputs(cuda, 2, 8, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ml.mlstm(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, ig, fg)
    with pytest.raises(ValueError, match="dtypes"):
        ml.mlstm(q, k.bfloat16(), v, ig, fg)
    with pytest.raises(ValueError, match="dtypes"):
        ml.mlstm(q, k, v, ig.bfloat16(), fg)
    with pytest.raises(ValueError, match="shapes"):
        ml.mlstm(q, k, v, ig[:, :4], fg)
    with pytest.raises(ValueError, match="chunk"):
        ml.mlstm(q, k, v, ig, fg, chunk=3)
    big = torch.zeros((1, 4, 1, 520), device=cuda)
    gate = torch.zeros((1, 4, 1), device=cuda)
    with pytest.raises(ValueError, match="D <= 512"):
        ml.mlstm(big, big, big, gate, gate)
    with pytest.raises(ValueError, match="CUDA"):
        ml.mlstm(q.cpu(), k.cpu(), v.cpu(), ig.cpu(), fg.cpu())


def test_xlstm_smoke_model_on_card_matches_cpu(cuda):
    """The smoke model (7 mLSTM + 1 sLSTM, norm_eps 1e-2 so that the
    per-head norm is not steep): the forward launches each kernel once per
    layer and agrees with the CPU's plain versions; prefill and decode
    launch neither and agree with the CPU's recurrences."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import slstm as sl
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(configs.get_smoke("xlstm_350m"), norm_eps=1e-2)
    params = T.init_lm(cfg, seed=0, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(5))
    outs = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        with torch.no_grad():
            m0, s0 = ml.LAUNCHES, sl.LAUNCHES
            fwd, _ = T.lm_forward(p, {"tokens": toks[:, :32].to(dev)}, cfg)
            counts = (ml.LAUNCHES - m0, sl.LAUNCHES - s0)
            cache = T.init_cache(cfg, 2, 64, device=dev)
            pre, cache = T.lm_prefill(p, {"tokens": toks[:, :32].to(dev)},
                                      cfg, cache)
            dec, _ = T.lm_decode_step(
                p, toks[:, 32:].to(dev).int(),
                torch.full((2, 1), 32, dtype=torch.int32, device=dev), cfg,
                cache)
            outs[str(dev)] = (fwd.cpu(), pre.cpu(), dec.cpu(), counts,
                              (ml.LAUNCHES - m0, sl.LAUNCHES - s0))
    host, card = outs["cpu"], outs[str(cuda)]
    assert card[3] == (7, 1) and card[4] == (7, 1) and host[4] == (0, 0)
    for a, b in zip(card[:3], host[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_train_cli_xlstm_smoke_on_card(cuda, tmp_path, capsys):
    """``launch.train --arch xlstm_350m --smoke`` on the card: per step
    one mlstm launch per mLSTM layer (7) and one slstm launch (1)."""
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import slstm as sl
    from repro_torch.launch import train

    m0, s0 = ml.LAUNCHES, sl.LAUNCHES
    assert train.main(["--arch", "xlstm_350m", "--smoke", "--steps", "3",
                       "--registry", str(tmp_path)]) == 0
    assert (ml.LAUNCHES - m0, sl.LAUNCHES - s0) == (3 * 7, 3 * 1)
    assert "[train] done; final loss" in capsys.readouterr().out


def _final_loss(text):
    loss = float(text.split("[train] done; final loss")[1].split()[0])
    assert math.isfinite(loss), loss
    return loss


def test_train_cli_recurrentgemma_smoke_on_card(cuda, tmp_path, capsys):
    """``launch.train --arch recurrentgemma_2b --smoke`` on the card: per
    step one rglru launch per RG-LRU layer (9) and one flash launch per
    local-attention layer (4, tf32x3 route); the pushes fingerprint on
    the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    from repro_torch.launch import train

    r0, f0, w0, p0 = rg.LAUNCHES, fa.LAUNCHES, fa.WGMMA_LAUNCHES, fp.LAUNCHES
    assert train.main(["--arch", "recurrentgemma_2b", "--smoke", "--steps",
                       "3", "--registry", str(tmp_path)]) == 0
    assert (rg.LAUNCHES - r0, fa.LAUNCHES - f0,
            fa.WGMMA_LAUNCHES - w0) == (3 * 9, 3 * 4, 0)
    assert fp.LAUNCHES > p0
    _final_loss(capsys.readouterr().out)


def test_train_cli_granite_smoke_on_card(cuda, tmp_path, capsys):
    """``launch.train --arch granite_moe_1b_a400m --smoke`` on the card:
    one flash launch per layer a step (2, tf32x3 route), the MoE
    gradients through the dispatch and combine gathers under
    deterministic mode; the pushes fingerprint on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    f0, p0 = fa.LAUNCHES, fp.LAUNCHES
    assert train.main(["--arch", "granite_moe_1b_a400m", "--smoke",
                       "--steps", "3", "--registry", str(tmp_path)]) == 0
    assert fa.LAUNCHES - f0 == 3 * 2
    assert fp.LAUNCHES > p0
    _final_loss(capsys.readouterr().out)


def test_whisper_smoke_loss_and_grads_on_card_match_cpu(cuda):
    """whisper_large_v3's smoke config (2 encoder + 2 decoder layers,
    float32) with stub audio frames: ``lm_loss`` and its gradients, the
    train step's, on the card against the CPU, each flash call (2 encoder,
    2 self, 2 cross) one launch on the tf32x3 route, and the encoder's,
    cross-attention's and ``dec_pos_embed``'s gradients not zero.
    Tolerances: tests/test_torch_train.py's float32 LOSS_TOL and
    GRAD_TOL (another sum order on each side)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticTokenDataset
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, unflatten

    cfg = configs.get_smoke("whisper_large_v3")
    params = T.init_lm(cfg, seed=0, device="cpu")
    batch = SyntheticTokenDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)).batch(0)
    batch["frames"] = np.random.default_rng([0, 0]).normal(
        0, 0.02, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    flat, treedef = flatten(params)
    runs = {}
    for dev in ("cpu", cuda):
        inputs = [t.detach().to(dev).requires_grad_() for t in flat]
        f0, w0 = fa.LAUNCHES, fa.WGMMA_LAUNCHES
        loss, _ = T.lm_loss(unflatten(treedef, inputs),
                            {k: torch.from_numpy(a).to(dev)
                             for k, a in batch.items()}, cfg)
        grads = torch.autograd.grad(loss, inputs)
        runs[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads],
                          (fa.LAUNCHES - f0, fa.WGMMA_LAUNCHES - w0))
    (h_loss, h_grads, h_n), (c_loss, c_grads, c_n) = runs.values()
    assert h_n == (0, 0) and c_n == (6, 0)
    assert c_loss == pytest.approx(h_loss, rel=1e-5)
    for a, b in zip(c_grads, h_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    index = {id(t): i for i, t in enumerate(flat)}
    named = dict(common.leaf_paths(params))
    for path in ("encoder/groups/b0/attn/wq", "groups/b0/cross_attn/wk",
                 "dec_pos_embed"):
        assert bool(c_grads[index[id(named[path])]].any()), path


def test_checkpointer_snapshot_leaves_the_card(cuda, tmp_path):
    """An async save takes each leaf's fingerprints on the card (one
    kernel launch a leaf) and copies its bytes to host memory: the card
    holds no second copy of the state, and the image is the one a
    blocking push of the same tensors gives."""
    from repro_torch.checkpoint import Checkpointer, Registry

    gen = torch.Generator(device=cuda).manual_seed(0)
    state = {"w": torch.randn((64, 1024, 1024), device=cuda, generator=gen),
             "b": torch.randn((3, 77), device=cuda, generator=gen)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ck = Checkpointer(Registry(str(tmp_path / "a")), "w")
    p0 = fp.LAUNCHES
    fut = ck.save(1, {"state": state})
    assert fp.LAUNCHES - p0 == 2
    # fingerprints and their scratch, not a copy of the 268 MB state
    assert torch.cuda.max_memory_allocated() - base < 2 ** 24
    state["w"].mul_(2.0)
    state["w"].div_(2.0)
    got = fut.result()
    want = Checkpointer(Registry(str(tmp_path / "b")), "w").save(
        1, {"state": state}, block=True)
    assert got.image_id == want.image_id


# ---------------------------------------------------------------------------
# the MoE FFN and init_lm on the card
# ---------------------------------------------------------------------------

def _granite_moe(route, capacity_factor=1.25):
    """granite_moe_1b_a400m's MoE layer at full width (32 experts top-8,
    d_model 1024, d_ff 512), drawn on the host for seed 3."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import common, moe

    cfg = dataclasses.replace(configs.get_config("granite_moe_1b_a400m"),
                              dtype="float32", moe_routing=route,
                              capacity_factor=capacity_factor)
    return cfg, common.materialize(moe.init_moe(cfg), 3, "moe")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("route", ["local", "global"])
def test_moe_layer_on_card_matches_cpu(cuda, route, capacity_factor):
    """granite's MoE layer in float32 on 8 x 32 tokens (the prefill's
    shape; at capacity factor 0.25 entries drop): the card picks the CPU's
    experts, its output lies within float32 sum-order error of the CPU's,
    and two calls give the same bits."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    cfg, params = _granite_moe(route, capacity_factor)
    on_card = tree_map(lambda t: t.to(cuda), params)
    x = torch.randn((8, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    want, want_aux = moe.moe_forward(params, x, cfg)
    got, aux = moe.moe_forward(on_card, x.to(cuda), cfg)
    again, _ = moe.moe_forward(on_card, x.to(cuda), cfg)
    assert torch.equal(got, again)
    ids = moe._router(params, x, cfg)[1]
    assert torch.equal(moe._router(on_card, x.to(cuda), cfg)[1].cpu(), ids)
    err = (got.cpu() - want).norm() / want.norm()
    assert err < 1e-5, err
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0)


def test_moe_ties_on_card_take_the_lower_index(cuda):
    """Equal router logits on the card (an all-zero row of x, and
    duplicated router columns) pick experts in index order, as on the
    CPU."""
    from repro_torch.models import moe

    cfg, params = _granite_moe("local")
    router = params["router"].clone()
    router[:, 9] = router[:, 4]
    router[:, 17] = router[:, 4]
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(8))
    x[0, :3] = 0.0
    got = moe._router({"router": router.to(cuda)}, x.to(cuda), cfg)[1].cpu()
    want = moe._router({"router": router}, x, cfg)[1]
    assert torch.equal(got, want)
    assert got[0, :3].tolist() == [list(range(8))] * 3
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.1, 0.3]], device=cuda)
    assert moe.top_k(probs, 4)[1].tolist() == [[1, 2, 4, 0]]


def test_init_lm_on_card_bit_equal_to_cpu(cuda):
    """One seed, the same params on the card as on the CPU (drawn on the
    host, copied block by block), and a leaf of several blocks likewise."""
    from repro_torch import configs
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten

    cfg = configs.get_smoke("granite_moe_1b_a400m")
    host, host_def = flatten(T.init_lm(cfg, seed=4, device="cpu"))
    card, card_def = flatten(T.init_lm(cfg, seed=4, device=cuda))
    assert host_def == card_def
    for h, c in zip(host, card):
        assert c.device.type == "cuda" and torch.equal(c.cpu(), h)
    leaf = common.param((3 * common.BLOCK // 1000 + 7, 1000))
    assert torch.equal(common.materialize(leaf, 4, "w", device=cuda).cpu(),
                       common.materialize(leaf, 4, "w"))


@pytest.mark.parametrize("arch,kernel", [("smollm_360m", "flash_attention"),
                                         ("recurrentgemma_2b", "rglru"),
                                         ("xlstm_350m", "mlstm")])
def test_remat_policies_give_the_same_bits_on_card(cuda, arch, kernel):
    """``lm_loss`` and its gradients of a smoke config on the card under
    ``remat="dots"`` and ``"full"`` are ``"none"``'s bits, and the
    recompute launches the hand-written kernel of each layer again: twice
    ``none``'s launches (each group's kernel calls are inside the group,
    never its last op)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import rglru as rg
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, unflatten

    mod = {"flash_attention": fa, "rglru": rg, "mlstm": ml}[kernel]
    cfg = configs.get_smoke(arch)
    params = T.init_lm(cfg, seed=0, device=cuda)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                        dtype=torch.int32).to(cuda)
    batch = {"tokens": tok, "labels": tok}
    flat, treedef = flatten(params)
    runs = {}
    for remat in ("none", "dots", "full"):
        inputs = [t.detach().requires_grad_() for t in flat]
        n0 = mod.LAUNCHES
        loss, _ = T.lm_loss(unflatten(treedef, inputs), batch, cfg,
                            remat=remat)
        grads = torch.autograd.grad(loss, inputs)
        runs[remat] = (loss.detach(), grads, mod.LAUNCHES - n0)
    loss0, grads0, n = runs["none"]
    assert n > 0
    for remat in ("dots", "full"):
        loss, grads, m = runs[remat]
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
        assert m == 2 * n
