"""The paper's case-study models (PyTorch), as in ``repro.models.cnn``: the
SFC MLP (MNIST) and ResNet-9 (CIFAR), with per-layer LUT-MU substitution.

Params are plain dicts of tensors with the JAX package's keys and layouts
(dense weights ``(D_in, D_out)``, convolutions HWIO, activations NHWC), so
``convert.params_from_jax`` carries a JAX tree across.  Init draws from an
explicit ``torch.Generator``; minibatch indices and calibration subsamples
are the JAX package's ``np.random.default_rng`` draws, so both packages
train and fit on the same rows.  Convolutions are lowered by Kn2col
(pruning-friendly) or Im2col (the original Halutmatmul), and every
substituted matmul goes through ``kernels.dispatch.lutmu_matmul``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import conv as CV
from repro_torch.core import lut_mu as LM
from repro_torch.core import maddness as M
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Tensor = torch.Tensor


def _sgd(params: dict, loss_fn, xb: Tensor, yb: Tensor, lr: float
         ) -> Tuple[dict, Tensor]:
    """One plain SGD step on a dict of leaf tensors."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, xb, yb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - lr * g).detach()
           for (k, v), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def _train(params: dict, loss_fn, x: np.ndarray, y: np.ndarray, steps: int,
           lr: float, batch: int, seed: int) -> Tuple[dict, List[Tensor]]:
    """``steps`` SGD steps on minibatches drawn as the JAX package draws
    them; returns the params and each step's loss."""
    dev = next(iter(params.values())).device
    xd = torch.as_tensor(np.asarray(x), device=dev)
    yd = torch.as_tensor(np.asarray(y), device=dev).to(torch.int64)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, x.shape[0], size=batch),
                              device=dev)
        params, loss = _sgd(params, loss_fn, xd[idx], yd[idx], lr)
        losses.append(loss)
    return params, losses


# ---------------------------------------------------------------------------
# SFC MLP (paper Table I): 784 → 256 → 256 → 256 → 10
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    sizes: Tuple[int, ...] = (784, 256, 256, 256, 10)


def init_mlp(cfg: MLPConfig, gen: torch.Generator) -> dict:
    n = len(cfg.sizes) - 1
    params = {f"w{i}": L.dense_init(gen, cfg.sizes[i], cfg.sizes[i + 1])
              for i in range(n)}
    params.update({f"b{i}": torch.zeros((cfg.sizes[i + 1],),
                                        device=gen.device) for i in range(n)})
    return params


def mlp_forward(params: dict, x: Tensor, n_layers: int) -> Tensor:
    h = x
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.relu(h)
    return h


def mlp_train(cfg: MLPConfig, x: np.ndarray, y: np.ndarray, *,
              steps: int = 300, lr: float = 0.05, batch: int = 128,
              seed: int = 0, device="cuda") -> dict:
    """Plain SGD trainer for the case-study MLP on ``device``."""
    n_layers = len(cfg.sizes) - 1
    dev = resolve_device(device)
    params = init_mlp(cfg, torch.Generator(device=dev).manual_seed(seed))

    def loss_fn(p, xb, yb):
        return L.softmax_cross_entropy(mlp_forward(p, xb, n_layers), yb)

    return _train(params, loss_fn, x, y, steps, lr, batch, seed)[0]


@torch.no_grad()
def mlp_accuracy(forward: Callable[[Tensor], Tensor], x: np.ndarray,
                 y: np.ndarray, device="cuda") -> float:
    """Top-1 accuracy of ``forward`` (any of the case-study models) on
    ``x``, moved to ``device``."""
    xt = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    pred = torch.argmax(forward(xt), dim=-1).cpu().numpy()
    return float((pred == np.asarray(y)).mean())


def mlp_to_amm(params: dict, cfg: MLPConfig, calib_x,
               num_codebooks: Sequence[int], depths: Sequence[int],
               quantize_int8: bool = False, retrain_steps: int = 0,
               device=None) -> LM.AMMChain:
    """Replace every matmul with a pruned LUT-MU chain (paper Fig. 10),
    compiled by the offline compiler on ``device`` (default: the params');
    ``retrain_steps`` applies the paper's layer-wise accuracy recovery."""
    from repro_torch.compiler import compile_chain  # compiler sits above models

    n_layers = len(cfg.sizes) - 1
    dev = device if device is not None else params["w0"].device
    weights = [params[f"w{i}"].detach().cpu().numpy() for i in range(n_layers)]
    biases = [params[f"b{i}"].detach().cpu().numpy() for i in range(n_layers)]
    chain = compile_chain(
        weights, biases, M.as_tensor(calib_x, torch.float64, dev),
        num_codebooks=list(num_codebooks), depths=list(depths),
        activations=["relu"] * (n_layers - 1),
        resolution="int8" if quantize_int8 else "float32").chain
    if retrain_steps:
        chain = LM.retrain_chain(chain, weights, biases, calib_x,
                                 steps=retrain_steps, device=dev)
    return chain


# ---------------------------------------------------------------------------
# ResNet-9 (paper Fig. 9/11, Table II): CIFAR-scale
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResNet9Config:
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    num_classes: int = 10
    quant_bits: int = 4  # the paper's INT4 base model


CONV_ORDER = ("conv0", "conv1", "res1a", "res1b", "conv2", "conv3", "res2a",
              "res2b")


def init_resnet9(cfg: ResNet9Config, gen: torch.Generator) -> dict:
    """conv1 → block1(conv+res) → conv2 → block2(conv+res) → head."""
    c = cfg.channels
    dev = gen.device

    def conv(cin, cout):
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev)
        return w / float(np.sqrt(9 * cin))

    shapes = {"conv0": (3, c[0]), "conv1": (c[0], c[1]),
              "res1a": (c[1], c[1]), "res1b": (c[1], c[1]),
              "conv2": (c[1], c[2]), "conv3": (c[2], c[3]),
              "res2a": (c[3], c[3]), "res2b": (c[3], c[3])}
    params = {name: conv(*shapes[name]) for name in CONV_ORDER}
    params["head"] = L.dense_init(gen, c[3], cfg.num_classes)
    params["head_b"] = torch.zeros((cfg.num_classes,), device=dev)
    return params


def _pool(x: Tensor) -> Tensor:
    """2×2 max pool, stride 2, ``VALID`` (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def resnet9_forward(params: dict, x: Tensor,
                    conv_fns: Optional[dict] = None) -> Tensor:
    """``conv_fns`` optionally maps a layer name to ``callable(x, w)``
    substituting its convolution (the LUT-MU path); exact otherwise."""
    def conv(name, h):
        w = params[name]
        if conv_fns and name in conv_fns:
            return conv_fns[name](h, w)
        return CV.conv_reference(h, w)

    h = F.relu(conv("conv0", x))
    h = _pool(F.relu(conv("conv1", h)))
    r = F.relu(conv("res1a", h))
    r = F.relu(conv("res1b", r))
    h = h + r
    h = _pool(F.relu(conv("conv2", h)))
    h = _pool(F.relu(conv("conv3", h)))
    r = F.relu(conv("res2a", h))
    r = F.relu(conv("res2b", r))
    h = h + r
    h = h.mean(dim=(1, 2))
    return h @ params["head"] + params["head_b"]


def resnet9_train(cfg: ResNet9Config, x: np.ndarray, y: np.ndarray, *,
                  steps: int = 200, lr: float = 0.02, batch: int = 64,
                  seed: int = 0, device="cuda") -> dict:
    """Plain SGD trainer for ResNet-9 on ``device``."""
    dev = resolve_device(device)
    params = init_resnet9(cfg, torch.Generator(device=dev).manual_seed(seed))

    def loss_fn(p, xb, yb):
        return L.softmax_cross_entropy(resnet9_forward(p, xb), yb)

    return _train(params, loss_fn, x, y, steps, lr, batch, seed)[0]


@torch.no_grad()
def capture_conv_inputs(params: dict, calib_x) -> Dict[str, Tensor]:
    """Each conv layer's input when ``calib_x`` runs through the exact
    network (conv1 … res2b; conv0 takes the images)."""
    dev = params["conv0"].device
    ref = CV.conv_reference
    h = F.relu(ref(M.as_tensor(calib_x, torch.float32, dev), params["conv0"]))
    cap = {"conv1": h}
    h1 = _pool(F.relu(ref(h, params["conv1"])))
    cap["res1a"] = h1
    r = F.relu(ref(h1, params["res1a"]))
    cap["res1b"] = r
    h2 = h1 + F.relu(ref(r, params["res1b"]))
    cap["conv2"] = h2
    h3 = _pool(F.relu(ref(h2, params["conv2"])))
    cap["conv3"] = h3
    h4 = _pool(F.relu(ref(h3, params["conv3"])))
    cap["res2a"] = h4
    cap["res2b"] = F.relu(ref(h4, params["res2a"]))
    return cap


def _subsample(rows: Tensor, n: int = 2048) -> Tensor:
    pick = np.random.default_rng(0).choice(rows.shape[0],
                                           size=min(n, rows.shape[0]),
                                           replace=False)
    return rows[torch.as_tensor(pick, device=rows.device)]


def resnet9_amm_conv_fns(params: dict, calib_x, *, mode: str = "kn2col",
                         d_sub: int = 8, depth: int = 4,
                         layers: Optional[Sequence[str]] = None,
                         quantize_int8: bool = False, backend: str = "auto"
                         ) -> Tuple[dict, Dict[str, List[LM.AMMLinear]]]:
    """Fit LUT-MU substitutes for conv layers 2..8 (paper §VI-B: the first
    conv and the final FC stay exact), on the params' device.

    mode: ``"kn2col"`` (one LUT-MU per kernel tap, codebooks of ``d_sub``
    channels) or ``"im2col"`` (the original Halutmatmul: one LUT-MU over
    the unfolded windows, codebooks of K·K dims), each fitted on the
    layer's input when ``calib_x`` runs through the exact network.  Returns
    ``(conv_fns, fitted)``; ``fitted[name]`` lists
    the layer's LUT-MUs for resource accounting.  ``backend`` threads to
    ``kernels.dispatch.lutmu_matmul`` for every substituted matmul."""
    layers = list(layers if layers is not None else CONV_ORDER[1:])
    captured = capture_conv_inputs(params, calib_x)
    conv_fns, fitted = {}, {}
    for name in layers:
        w = params[name]  # (3, 3, Cin, Cout)
        k, _, cin, cout = w.shape
        xin = captured[name].to(torch.float64)
        if mode == "im2col":
            flat = CV.im2col_patches(xin, k).reshape(-1, k * k * cin)
            lin = LM.fit_amm_linear(
                _subsample(flat), w.reshape(-1, cout), None, cin, depth=depth,
                quantize_int8=quantize_int8)
            conv_fns[name] = partial(
                CV.conv_im2col,
                matmul=lambda a, _w, lin=lin: lin(a, backend=backend))
            fitted[name] = [lin]
        else:
            sub = _subsample(xin.reshape(-1, cin))
            taps = [LM.fit_amm_linear(
                sub, w.reshape(k * k, cin, cout)[t], None, cin // d_sub,
                depth=depth, quantize_int8=quantize_int8, seed=t)
                for t in range(k * k)]
            conv_fns[name] = partial(
                CV.conv_kn2col,
                tap_matmuls=[lambda a, l=l: l(a, backend=backend)
                             for l in taps])
            fitted[name] = taps
    return conv_fns, fitted
