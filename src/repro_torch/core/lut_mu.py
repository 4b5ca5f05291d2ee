"""LUT-MU: the paper's pruned LUT-based approximate matmul unit (PyTorch).

The serving half of ``repro.core.lut_mu``:

  * :class:`AMMLinear` — one LUT-MU (allocator → encoder → aggregator), a
    drop-in replacement for ``x @ W + b`` with optional *parameter-pruned*
    output (when the consumer is another AMMLinear);
  * :class:`AMMChain`  — a cascade of AMMLinears with *data-pruned* hand-off
    between them (the paper's Fig. 4 dataflow), with optional elementwise
    non-linear ops between stages (dimension-preserving, so pruning
    commutes);
  * :func:`fit_amm_linear` / :func:`fit_amm_chain` — offline fitting
    functions (on the device of their calibration input).

Every forward goes through ``kernels.dispatch.lutmu_matmul``; the
``backend`` keyword threads straight to it (default ``"auto"``).
:func:`retrain_chain` is the paper's layer-wise LUT retraining, through the
straight-through path of ``core/ste.py`` (the encode and aggregate kernels
on the card).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import maddness as M
from repro_torch.core import pruning as P
from repro_torch.core import ste as STE
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import dispatch as D

Tensor = torch.Tensor

# Optional approximation-quality probe tap (serving/quality.py).  When a
# tap is installed, every *eager* LUT-MU forward also reports its input,
# params and output, so the probe can replay the dense reference on the
# same activations.  Two rules keep it observation-only:
#   * ``None`` (the default) costs one host ``is not None`` check;
#   * calls made while a CUDA graph is being captured are skipped — a tap
#     inside a captured step program would fire once, at capture, and
#     never on a replay — so taps see eager calls only.
_PROBE_TAP = None


def set_probe_tap(tap) -> None:
    """Install (or clear, with ``None``) the LUT-MU quality-probe tap."""
    global _PROBE_TAP
    _PROBE_TAP = tap


def _tap_eager(proj: str, x: Tensor, params: M.MaddnessParams, out: Tensor,
               input_kind: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    _PROBE_TAP(proj=proj, x=x, params=params, out=out, input_kind=input_kind)


@dataclasses.dataclass
class AMMLinear:
    """One LUT-MU.  ``out_plan`` present ⇒ this unit emits the pruned,
    cluster-ordered package for the next unit instead of the full output."""

    params: M.MaddnessParams
    out_plan: Optional[P.PruningPlan]  # pruning of *our output*
    full_out_features: int  # D_out before parameter pruning
    # launch plan fixed by the offline compiler's planner; None ⇒ the
    # engine resolves one per call (cache → the wrappers' own pick)
    tiles: Optional[AT.TileConfig] = None

    @property
    def num_codebooks(self) -> int:
        return self.params.tree.num_codebooks

    @property
    def depth(self) -> int:
        return self.params.tree.depth

    @property
    def is_pruned(self) -> bool:
        return self.out_plan is not None

    def __call__(self, x: Tensor, *, backend: str = "auto") -> Tensor:
        """Full-width input path."""
        y = D.lutmu_matmul(x, self.params, backend=backend, input_kind="full",
                           tiles=self.tiles)
        if _PROBE_TAP is not None:
            _tap_eager("linear", x, self.params, y, "full")
        return y

    def apply_package(self, x_pruned: Tensor, *,
                      backend: str = "auto") -> Tensor:
        """Pruned-package input path (chained mode)."""
        y = D.lutmu_matmul(x_pruned, self.params, backend=backend,
                           input_kind="package", tiles=self.tiles)
        if _PROBE_TAP is not None:
            _tap_eager("linear", x_pruned, self.params, y, "package")
        return y

    # -- resource accounting (paper Figs. 11/12) -----------------------------
    def lut_bytes(self) -> int:
        return self.params.lut.numel() * self.params.lut.element_size()

    def workload_ops(self) -> int:
        return P.workload_ops(self.num_codebooks, self.depth,
                              self.params.lut.shape[-1])


@dataclasses.dataclass
class AMMChain:
    """Cascaded LUT-MUs with pruned hand-off (paper Fig. 4).

    ``activation_names[i]`` is the elementwise function applied between
    stage *i* and *i+1* (identity if None); it acts on the *pruned package*,
    which is valid because elementwise ops neither hide nor move split dims
    (Section V-A1).  ``"gelu"`` is the tanh approximation, as
    ``jax.nn.gelu``'s default.
    """

    layers: List[AMMLinear]
    activation_names: Tuple[Optional[str], ...]  # len == len(layers) - 1
    # per-layer engine backends recorded by the offline compiler's planner;
    # None ⇒ every layer follows the ``backend`` keyword (default "auto")
    backends: Optional[Tuple[str, ...]] = None

    _ACTS = {
        None: lambda x: x,
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
    }

    def _layer_backend(self, i: int, backend: str) -> str:
        if backend == "auto" and self.backends is not None:
            return self.backends[i]
        return backend

    def __call__(self, x: Tensor, *, backend: str = "auto") -> Tensor:
        h = self.layers[0](x, backend=self._layer_backend(0, backend))
        for i, layer in enumerate(self.layers[1:]):
            h = self._ACTS[self.activation_names[i]](h)
            be = self._layer_backend(i + 1, backend)
            if self.layers[i].is_pruned:
                # the producer emitted the cluster-ordered pruned package
                h = layer.apply_package(h, backend=be)
            else:
                h = layer(h, backend=be)  # unpruned hand-off: full width
        return h

    @classmethod
    def load(cls, path, device="cuda") -> "AMMChain":
        """Load a compiled chain from an offline-compiler artifact dir."""
        from repro_torch.compiler.artifact import load_artifact  # no cycle

        return load_artifact(path).to_chain(device=device)

    def lut_bytes(self) -> int:
        return sum(l.lut_bytes() for l in self.layers)

    def workload_ops(self) -> int:
        return sum(l.workload_ops() for l in self.layers)


# ---------------------------------------------------------------------------
# Offline fitting.
# ---------------------------------------------------------------------------


def _pruned(params: M.MaddnessParams, plan: P.PruningPlan) -> M.MaddnessParams:
    """``params`` with its LUT (and per-column scale) cut to ``plan``."""
    lut, offset = P.prune_lut(params.lut, params.lut_offset, plan)
    scale = params.lut_scale
    if scale.dim():  # per-column scales must be pruned too
        scale = scale[plan.keep_idx]
    return M.MaddnessParams(params.tree, params.prototypes, lut, scale, offset)


def fit_amm_linear(calib_x, weight, bias, num_codebooks: int, depth: int = 4,
                   out_plan: Optional[P.PruningPlan] = None,
                   quantize_int8: bool = False,
                   optimize_prototypes: bool = True, seed: int = 0,
                   device=None) -> AMMLinear:
    """Fit one LUT-MU on ``device`` (default: ``calib_x``'s); with
    ``out_plan`` the LUT is parameter-pruned."""
    params = M.fit_maddness(
        calib_x, weight, num_codebooks, depth=depth, bias=bias,
        quantize_int8=quantize_int8, optimize_prototypes=optimize_prototypes,
        seed=seed, device=device)
    if out_plan is not None:
        params = _pruned(params, out_plan)
    return AMMLinear(params=params, out_plan=out_plan,
                     full_out_features=int(weight.shape[1]))


def fit_amm_chain(calib_x, weights: Sequence, biases: Sequence,
                  num_codebooks: Sequence[int], depths: Sequence[int],
                  activations: Sequence[Optional[str]] = (),
                  quantize_int8: bool = False,
                  optimize_prototypes: bool = True, seed: int = 0,
                  device=None) -> AMMChain:
    """Fit a cascade layer by layer, propagating *approximate* activations
    (the paper's layer-wise order) and wiring pruning plans: stage *i*'s
    tree is fitted on the approximate full-width activations reaching it,
    then stage *i-1*'s LUT is pruned to stage *i*'s plan."""
    n_layers = len(weights)
    acts = tuple(activations) if activations else (None,) * (n_layers - 1)
    if len(acts) != n_layers - 1:
        raise ValueError(f"{n_layers} layers need {n_layers - 1} activations, "
                         f"got {len(acts)}")
    x = M.as_tensor(calib_x, torch.float64, device)
    stage_params: List[M.MaddnessParams] = []
    for i in range(n_layers):
        p = M.fit_maddness(
            x, weights[i], num_codebooks[i], depth=depths[i], bias=biases[i],
            quantize_int8=quantize_int8,
            optimize_prototypes=optimize_prototypes, seed=seed + i)
        stage_params.append(p)
        if i < n_layers - 1:
            y = M.maddness_matmul(x.to(torch.float32), p)
            x = AMMChain._ACTS[acts[i]](y).to(torch.float64)
    layers: List[AMMLinear] = []
    for i, p in enumerate(stage_params):
        full_out = int(weights[i].shape[1])
        plan = None
        if i < n_layers - 1:
            plan = P.plan_from_consumer_tree(stage_params[i + 1].tree,
                                             consumer_in_dim=full_out)
            p = _pruned(p, plan)
        layers.append(AMMLinear(params=p, out_plan=plan,
                                full_out_features=full_out))
    return AMMChain(layers=layers, activation_names=acts)


def retrain_chain(chain: AMMChain, weights: Sequence, biases: Sequence,
                  calib_x, steps: int = 150, lr: float = 0.3,
                  device=None) -> AMMChain:
    """Layer-wise LUT retraining (the paper's accuracy recovery, via [25]).

    Stage by stage: propagate the *approximate* full-width activations of
    the retrained prefix, fine-tune the stage's **unpruned** float LUT
    (bias folded into codebook 0) so its output matches the exact matmul of
    that approximate input, then re-apply parameter pruning — exact, since
    the MSE is separable by column.  Each stage encodes its input to a
    float32 one-hot once (the encode kernel on the card) and every step
    aggregates it with the LUT (the aggregate kernel) and takes the LUT's
    gradient as ``core/ste.py`` does.  Runs on ``device`` (default: the
    chain's)."""
    dev = device if device is not None else chain.layers[0].params.lut.device
    x = M.as_tensor(calib_x, torch.float32, dev)
    new_layers: List[AMMLinear] = []
    for i, layer in enumerate(chain.layers):
        p = layer.params
        w = M.as_tensor(weights[i], torch.float32, dev)
        b = (torch.zeros((w.shape[1],), dtype=torch.float32, device=dev)
             if biases[i] is None else M.as_tensor(biases[i], torch.float32,
                                                   dev))
        with M.exact_fp32_matmul():
            target = x @ w + b  # exact matmul on the approximate input
        lut_f, _, _ = M.build_lut(p.prototypes.to(dev), w, None,
                                  quantize_int8=False)
        lut_f[0] += b
        onehot = STE.encode_float_onehot(x, p.tree)
        for _ in range(steps):
            lut_ = lut_f.requires_grad_(True)
            y = STE.OneHotAggregate.apply(onehot, lut_)
            loss = torch.mean((y - target) ** 2)
            (g,) = torch.autograd.grad(loss, lut_)
            lut_f = (lut_ - lr * g).detach()
        if i < len(chain.layers) - 1:  # approximate full-width activations
            y_full = STE.OneHotAggregate.apply(onehot, lut_f)
            x = AMMChain._ACTS[chain.activation_names[i]](y_full)
        lut_new = lut_f
        offset_new = torch.zeros((lut_f.shape[-1],), dtype=torch.float32,
                                 device=dev)
        if layer.out_plan is not None:
            keep = layer.out_plan.keep_idx.to(dev)
            lut_new, offset_new = lut_f[..., keep], offset_new[keep]
        new_p = M.MaddnessParams(
            p.tree, p.prototypes, lut_new.contiguous(),
            torch.ones((), dtype=torch.float32, device=dev), offset_new)
        new_layers.append(AMMLinear(params=new_p, out_plan=layer.out_plan,
                                    full_out_features=layer.full_out_features))
    return AMMChain(layers=new_layers, activation_names=chain.activation_names)


def unpruned_chain(chain: AMMChain, weights: Sequence,
                   biases: Sequence) -> AMMChain:
    """Rebuild ``chain`` with full (unpruned) LUTs — the MADDNESS baseline,
    sharing the trees and prototypes (same encode, a larger table)."""
    layers = []
    for i, layer in enumerate(chain.layers):
        p = layer.params
        dev = p.prototypes.device
        lut, scale, offset = M.build_lut(
            p.prototypes, M.as_tensor(weights[i], torch.float32, dev),
            None if biases[i] is None
            else M.as_tensor(biases[i], torch.float32, dev),
            quantize_int8=p.lut.dtype == torch.int8)
        layers.append(AMMLinear(
            params=M.MaddnessParams(p.tree, p.prototypes, lut, scale, offset),
            out_plan=None, full_out_features=layer.full_out_features))
    return AMMChain(layers=layers, activation_names=chain.activation_names)
