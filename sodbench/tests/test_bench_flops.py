"""The operation and byte counters against counts made by hand at the cells'
shapes."""
import pytest

from sodbench import flops

D, N = 384, 785                # ViT-S/8 at 224 px: 28 x 28 patches + CLS


def test_vit_block_by_hand():
    # per token: qkv 384x1152, proj 384x384, fc1 384x1536, fc2 1536x384 = 1,769,472 MACs
    macs_linear = 384 * 1152 + 384 * 384 + 384 * 1536 + 1536 * 384
    assert macs_linear == 1_769_472
    # attention: q k^T and p v, 785 x 785 x 64 per head, 6 heads
    macs_attn = 2 * 6 * 785 * 785 * 64
    block = 2 * (785 * macs_linear + macs_attn)
    embed = 2 * 784 * 192 * 384
    assert flops.vit_flops(N) == embed + 12 * block
    assert flops.vit_flops(N) == 44_810_717_184


def test_decoder_and_heads_by_hand():
    q, n = 20, 784
    self_attn = 2 * (q * 384 * 1152 + 2 * q * q * 384 + q * 384 * 384)
    cross = 2 * (q * 384 * 384 + n * 384 * 768 + 2 * q * n * 384 + q * 384 * 384)
    ffn = 2 * (2 * q * 384 * 1536)
    assert flops.decoder_flops(n) == 6 * (self_attn + cross + ffn)
    # masks on the 56 x 56 pixel grid and the objectness MLP, six layers
    assert flops.heads_flops(56 * 56) == 6 * 20 * (2 * 3136 * 384 + 2 * (2 * 384 * 384 + 384))


def test_forward_and_train_at_224():
    fwd = flops.vit_flops(N) + flops.decoder_flops(784) + flops.heads_flops(3136)
    assert flops.forward_flops("vit_small", (224, 224)) == fwd
    assert flops.train_flops("vit_small", (224, 224)) == 3 * fwd
    assert 48e9 < fwd < 49e9


def test_resnet50_dilated8_by_hand():
    # stem 7x7/2 at 112 x 112; stride 4 after the pool (56 x 56); layer2 at 28;
    # layer3 and layer4 stay at 28 x 28 (dilated)
    def conv(co, ci, k, hw):
        return 2 * co * ci * k * k * hw * hw

    total = conv(64, 3, 7, 112)
    cin = 64
    for blocks, planes, hw_in, hw_out in ((3, 64, 56, 56), (4, 128, 56, 28),
                                         (6, 256, 28, 28), (3, 512, 28, 28)):
        for b in range(blocks):
            h_in = hw_in if b == 0 else hw_out
            total += conv(planes, cin, 1, h_in) + conv(planes, planes, 3, hw_out)
            total += conv(4 * planes, planes, 1, hw_out)
            if b == 0:
                total += conv(4 * planes, cin, 1, hw_out)
            cin = 4 * planes
    assert flops.resnet50_d8_flops(224, 224) == total
    assert flops.forward_flops("resnet50", (224, 224)) == (
        total + 2 * 784 * 2048 * 384 + flops.decoder_flops(784) + flops.heads_flops(3136))


def test_k2_counts():
    ops, nbytes = flops.k2_forward(32, 6, N, 64)
    assert ops == 4 * 32 * 6 * N * N * 64 and nbytes == 4 * 32 * 6 * N * 64 * 2
    ops_b, bytes_b = flops.k2_backward(32, 6, N, 64)
    assert ops_b == 2 * ops and bytes_b == 2 * nbytes + 2 * 32 * 6 * N * 4
    # the forward at B=32 is compute-bound: 30.6 us at 989 TFLOP/s
    assert flops.bound_s(ops, nbytes) == pytest.approx(ops / 989e12)
    assert flops.bound_s(ops, nbytes) == pytest.approx(30.6256e-6, rel=1e-4)
    masked = flops.k2_forward_masked([2501, 901], 6, 64)
    assert masked == (4 * 6 * 64 * (2501 ** 2 + 901 ** 2), 4 * 6 * 64 * 2 * (2501 + 901))


def test_k1_counts():
    ops, nbytes = flops.k1_block(32, N)
    assert ops == 2 * 32 * N * 1_769_472 + 4 * 32 * N * N * 384
    weights = 2 * 1_769_472 + 4 * (1152 + 1152 + 1536)
    assert nbytes == weights + 2 * 32 * N * 384 * 2
    # twelve blocks of a B=32 forward: 1.446 ms at the bf16 peak
    assert 12 * flops.bound_s(ops, nbytes) == pytest.approx(1.44615e-3, rel=1e-4)


def test_canvas_flops_on_real_tokens():
    n = 51 * 26 + 1
    assert flops.canvas_flops([n]) == (flops.vit_flops(n) + flops.decoder_flops(n - 1)
                                       + flops.heads_flops(4 * (n - 1), layers=1))
