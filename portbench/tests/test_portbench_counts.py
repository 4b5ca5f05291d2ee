"""The frozen counts against hand-worked values."""
import json
from pathlib import Path

import pytest
import torch

from portbench import counts as K

ROOT = Path(__file__).resolve().parents[2]
RESNET = json.loads((ROOT / "portbench/configs/resnet9-cifar10-kn2col.json").read_text())
QWEN = json.loads((ROOT / "portbench/configs/qwen3-14b-lutmu.json").read_text())


def test_resnet9_image_flops():
    # conv0 3.54 M; conv1 151.0 M; res1a, res1b 75.5 M; conv2 151.0 M;
    # conv3 151.0 M; res2a, res2b 75.5 M; head 10 k
    assert K.resnet9_image_flops(RESNET) == pytest.approx(758_523_904.0)
    assert round(K.resnet9_image_flops(RESNET) / 1e9, 2) == 0.76


def test_kn2col_calls():
    calls = list(K.kn2col_calls(RESNET, 256))
    assert len(calls) == 63
    assert calls[0] == ("conv1", 262_144, 8, 128)
    assert calls[-1] == ("res2b", 4096, 64, 512)


def test_rows_needed():
    codes = torch.tensor([[0, 15], [0, 3], [1, 3], [0, 15]])
    assert int(K.rows_needed(codes, 16)) == 4   # (0,0) (0,1) (1,3) (1,15)
    seen = K.TableRows(16)
    seen(codes)
    seen(torch.tensor([[2, 2], [2, 2], [2, 2], [2, 2]]))
    assert seen.share(4, 2) == (4 + 2) / 2 / 32
    assert seen.share(8, 2) is None


def test_bound_ms():
    ms, by = K.bound_ms(3.35e9, 1.0, K.ADD_OPS_PER_S)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = K.bound_ms(0.0, 67e9, K.ADD_OPS_PER_S)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_lutmu_bound_gate_up_at_decode():
    # B=32, C=640, N=8704, every table row: x 327,680 B + thr 38,400 B +
    # LUT 10240·8704 B + epilogue 69,632 B + out 1,114,112 B
    ms, by = K.lutmu_bound_ms(32, 640, 8704, 4, 1, 640 * 16)
    nbytes = 32 * 640 * 4 * 4 + 640 * 15 * 4 + 640 * 16 * 8704 + 2 * 8704 * 4 + 32 * 8704 * 4
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)
    assert ms == pytest.approx(0.027068, rel=1e-4)


def test_lm_flops():
    # per token: 40 × (2·(26.2 M + 10.5 M + 26.2 M) + 6·5120·17408) FLOPs
    proj = 5120 * 5120 * 2 + 2 * 5120 * 1024
    per_layer = 2 * proj + 6 * 5120 * 17408
    assert K.lm_token_flops(QWEN, 0, False) == 40 * per_layer
    head = 2 * 5120 * 151936
    attn = 40 * 4 * 5120 * 100
    assert K.lm_token_flops(QWEN, 100, True) == 40 * per_layer + attn + head
    # a span is the sum of its tokens, each at its own context
    span = K.lm_span_flops(QWEN, 10, 3, 1)
    want = sum(K.lm_token_flops(QWEN, 10 + i + 1, False) for i in range(3)) + head
    assert span == pytest.approx(want)
