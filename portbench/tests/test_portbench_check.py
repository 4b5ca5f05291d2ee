"""The comparison that decides ``correct``, on the CPU at a size a test
holds: the port agrees with the plain reference on the benchmark's own
check; the control (the reference in the precision below the
configuration's) fails it; a run with the timed path broken underneath
comes out not correct."""
import pytest
import torch

LM = ["qwen3-14b-lutmu.batch-decode", "qwen3-14b-lutmu.chat-open"]
CNN = "resnet9-cifar10-kn2col.b256"


@pytest.mark.parametrize("workload", LM + [CNN])
def test_port_agrees_with_reference(run_tiny, workload):
    cell, _, out = run_tiny(workload, trace=True)
    assert out.correct, (out.problems, out.checks)
    assert all(c.value == 0.0 for c in out.checks.values())
    assert out.attempted > 0 and out.failed == 0
    if cell.config.DRIVER == "serve":
        sample = out.check_inputs[1]
        assert 0 < len(sample) <= cell.mix["engine"]["max_batch"]
        assert sum(len(g) for _, g in sample) >= 20


@pytest.mark.parametrize("workload", LM + [CNN])
def test_control_fails(run_tiny, workload):
    cell, drv, out = run_tiny(workload)
    name, check = next(iter(out.checks.items()))
    reading = drv.control(cell, out, "cpu")
    assert reading > check.limit, (name, reading, check.limit)


def _stale_kv(monkeypatch, vocab):
    from repro_torch.models import attention as A
    monkeypatch.setattr(A, "_page_write", lambda *a, **k: None)


def _half_batch(monkeypatch, vocab):
    from repro_torch.models import model as MD
    orig = MD.paged_decode_step

    def half(params, token, pos, table, cache, *a, **k):
        # half of the rows that hold a request left out (the odd ones among
        # them, or the only one): their logits are zeros
        out = orig(params, token, pos, table, cache, *a, **k).clone()
        trash = cache["k"].shape[1] - 1
        rows = torch.nonzero((table != trash).any(dim=1))[:, 0]
        out[rows[1::2] if len(rows) > 1 else rows] = 0.0
        return out
    monkeypatch.setattr(MD, "paged_decode_step", half)


def _altered_token(monkeypatch, vocab):
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine._sample
    calls = [0]

    def sample(self, *a, **k):
        toks = orig(self, *a, **k)
        calls[0] += 1
        if calls[0] % 5 == 0:
            toks = (toks + 1) % vocab
        return toks
    monkeypatch.setattr(ServeEngine, "_sample", sample)


@pytest.mark.parametrize("workload", LM)
@pytest.mark.parametrize("fault", [_stale_kv, _half_batch, _altered_token],
                         ids=["state_unchanged", "half_batch", "altered_token"])
def test_lm_faults_fail(run_tiny, monkeypatch, workload, fault):
    fault(monkeypatch, 512)
    # every chat request greedy, so that the few a CPU run finishes are
    # all checked
    _, _, out = run_tiny(workload, **({"greedy_every": 1}
                                      if "chat" in workload else {}))
    assert not out.correct


def _skipped_layer(monkeypatch):
    from repro_torch.core import conv as CV
    orig = CV.conv_kn2col
    monkeypatch.setattr(CV, "conv_kn2col",
                        lambda x, w, *a, **k: torch.zeros_like(orig(x, w, *a, **k)))


def _cnn_half_batch(monkeypatch):
    from repro_torch.models import cnn
    orig = cnn.resnet9_forward

    def half(params, x, conv_fns=None):
        out = orig(params, x[: x.shape[0] // 2], conv_fns)
        return torch.cat([out, torch.zeros_like(out)])
    monkeypatch.setattr(cnn, "resnet9_forward", half)


def _cnn_altered_answer(monkeypatch):
    from repro_torch.models import cnn
    orig = cnn.resnet9_forward

    def alter(params, x, conv_fns=None):
        out = orig(params, x, conv_fns)
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(cnn, "resnet9_forward", alter)


@pytest.mark.parametrize("fault", [_skipped_layer, _cnn_half_batch,
                                   _cnn_altered_answer],
                         ids=["layer_unchanged", "half_batch", "altered_answer"])
def test_cnn_faults_fail(run_tiny, monkeypatch, fault):
    fault(monkeypatch)
    _, _, out = run_tiny(CNN)
    assert not out.correct


@pytest.mark.cuda
def test_int_mm_sums_equal_gather_sums():
    """On the card the reference sums int8 tables with ``torch._int_mm``;
    its int32 sums equal the gather-sum's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.reference import maddness as MR
    g = torch.Generator(device="cuda").manual_seed(3)
    codes = torch.randint(0, 16, (64, 640), generator=g, device="cuda")
    lut = torch.randint(-128, 128, (640, 16, 512), generator=g,
                        dtype=torch.int8, device="cuda")
    want = lut.reshape(-1, 512)[codes + 16 * torch.arange(640, device="cuda")
                                ].sum(dim=1, dtype=torch.int32)
    assert torch.equal(MR.lut_sums(codes, lut), want)
