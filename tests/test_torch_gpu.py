"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when
torch finds no CUDA card.  Run them on a machine with one:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
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
        q_pos = torch.tensor([S // 2, S - 1, S // 3][:B], device=dev)
        k_pos = torch.arange(S, device=dev)[None].repeat(B, 1)
        k_pos = torch.where(k_pos <= q_pos[:, None], k_pos, -1)
    return q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 2048, 8, 4, 32),
                                         (2, 256, 8, 2, 64),
                                         (1, 128, 4, 4, 32),
                                         (3, 1000, 12, 3, 48)])
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
