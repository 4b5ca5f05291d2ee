"""Approximation-quality probes for the port's LUT-MU serving, as
``repro.serving.quality``.

A :class:`QualityProbe` attached to a live recorder (``rec.quality``)
samples a fraction of finished requests and **replays** their tokens
eagerly — outside every captured step program — through the model's own
forward (``models.model.capture_mlp_inputs`` + the LUT-MU probe tap of
``core/lut_mu.py`` / ``models/amm_mlp.py``).  For each LUT-MU layer the
replay yields the activations the engine saw, the LUT-MU approximation on
them, and (when the launcher supplies the pre-splice dense weights) the
dense reference on the *same* activations.

Recorded per probe, into the shared registry (the JAX package's names):

  * ``quality_rel_error{layer=,proj=}`` — per-token relative error of the
    LUT-MU projection vs the dense reference (``proj="gate"|"up"`` on
    identical inputs; ``proj="down"`` grades the whole layer output
    against the dense MLP on the same layer input);
  * ``quality_dead_buckets{layer=,tree=}`` /
    ``quality_bucket_utilisation{layer=,tree=}`` — cumulative
    codebook-bucket hits: a dead bucket is a prototype live traffic never
    selects;
  * ``quality_saturated_lookups_total{layer=,proj=,resolution=}`` (with
    ``quality_lookups_total`` as denominator) — gathered int8/int4 LUT
    entries at the quantisation extremes;
  * ``quality_probes_total`` / ``quality_probe_tokens_total`` /
    ``quality_probe_errors_total`` / ``quality_probe_skipped_total`` —
    the probe's own accounting.

Sliding-window speculative-acceptance drift comes from the SLO layer
(``slo_acceptance_drift``) and is folded into :meth:`QualityProbe.snapshot`.

Probes never alter emitted streams: the replay runs on copies of emitted
tokens, the taps fire on eager calls only, and nothing here touches engine
state.  On the card the replay launches the LUT-MU kernels eagerly, once
per projection and layer; those launches count in the kernels' counters
like any other.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.serving.obs import MetricsRegistry, log

__all__ = ["QualityProbe", "REL_ERROR_BUCKETS"]

REL_ERROR_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                     5e-2, 0.1, 0.25, 0.5, 1.0, 2.5)

# rows of gathered LUT entries counted at once (bounds the temporary at
# full width: 8 rows × 2,176 codebooks × 5,120 columns of int8)
_SAT_ROWS = 8


class QualityProbe:
    """Sampled dense-reference probing of the LUT-MU approximation.

    ``rate`` is the fraction of finished requests replayed (deterministic
    error-accumulator sampling, so a fixed workload probes a fixed set of
    requests); ``max_tokens`` caps the replay length per probe.  Engines
    call :meth:`bind` at init (via ``obs.quality``); the launcher may pass
    ``dense_params`` — the pre-splice params still carrying the dense
    ``mlp`` weights — to unlock the relative-error histograms (without
    them the probe still tracks utilisation and saturation)."""

    def __init__(self, registry: MetricsRegistry, *, rate: float = 0.05,
                 max_tokens: int = 32, dense_params=None):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"probe rate must be in (0, 1], got {rate}")
        self.registry = registry
        self.rate = float(rate)
        self.max_tokens = int(max_tokens)
        self._acc = 0.0
        self._params = None
        self._cfg = None
        self._dense = dense_params
        self._supported: Optional[bool] = None
        self._hits: Dict = {}          # (layer, tree) -> np.ndarray (C, G)
        self._keep_idx = None
        r = registry
        self._c_probes = r.counter(
            "quality_probes_total", "Finished requests replayed by the probe")
        self._c_tokens = r.counter(
            "quality_probe_tokens_total", "Tokens replayed by the probe")
        self._c_errors = r.counter(
            "quality_probe_errors_total", "Probe replays that raised")

    # -- wiring --------------------------------------------------------------
    def bind(self, params, cfg) -> None:
        """Bind the serving params and config the engine runs (the first
        engine to bind wins — a shared recorder probes the primary
        engine's model)."""
        if self._params is None:
            self._params = params
            self._cfg = cfg
            self._supported = None

    def _skip(self, reason: str) -> None:
        self.registry.counter(
            "quality_probe_skipped_total", "Probe opportunities skipped",
            reason=reason).inc()

    # -- sampling ------------------------------------------------------------
    def on_finish(self, req) -> None:
        """Called by ``Recorder.on_finish`` for every finished request;
        the accumulator fires the probe on a deterministic ``rate``
        fraction of them."""
        self._acc += self.rate
        if self._acc < 1.0:
            return
        self._acc -= 1.0
        if self._params is None:
            self._skip("unbound")
            return
        if self._supported is False:
            self._skip("family")
            return
        try:
            self._probe(req)
        except Exception as e:  # noqa: BLE001 — probes must not kill serving
            self._c_errors.inc()
            log("quality", f"probe failed on req {req.uid}: {e!r}",
                level="debug")

    # -- the probe -----------------------------------------------------------
    @torch.inference_mode()
    def _probe(self, req) -> None:
        from repro_torch.core import lut_mu as LU
        from repro_torch.models import model as MD

        layers = self._params.get("layers", {})
        if "amm_mlp" not in layers:
            self._skip("no_amm")
            return
        tokens = (list(req.prompt) + list(req.generated))[: self.max_tokens]
        if len(tokens) < 1:
            self._skip("empty")
            return
        tokens = np.asarray(tokens, np.int32)[None, :]  # (1, S)

        taps: List[dict] = []
        LU.set_probe_tap(lambda **kw: taps.append(kw))
        try:
            try:
                mlp_inputs = MD.capture_mlp_inputs(self._params, tokens,
                                                   self._cfg)
            except ValueError as e:
                if self._supported is not None:
                    raise
                self._supported = False
                log("quality", f"probe disabled: {e}", level="info")
                self._skip("family")
                return
            self._supported = True
        finally:
            LU.set_probe_tap(None)

        self._c_probes.inc()
        self._c_tokens.inc(tokens.shape[1])
        # group the tap stream into layers: the forward emits
        # gate → up → down per LUT-MU layer, in layer order
        layer = -1
        for tap in taps:
            if tap["proj"] == "gate":
                layer += 1
            if tap["proj"] == "linear":
                continue  # AMMChain taps (no layer context here)
            self._record_projection(layer, tap, mlp_inputs)

    def _dense_w(self, layer: int, name: str) -> Optional[torch.Tensor]:
        if self._dense is None:
            return None
        mlp = self._dense.get("layers", {}).get("mlp")
        if mlp is None or name not in mlp:
            return None
        return mlp[name][layer].to(torch.float32)

    def _keep_columns(self) -> torch.Tensor:
        """Pruned gate/up column index (cluster-ordered), reconstructed
        from the down tree — the plan the offline compiler used."""
        if self._keep_idx is None:
            from repro_torch.core import pruning as P
            from repro_torch.core.maddness import HashTree

            layers = self._params["layers"]["amm_mlp"]
            tree = HashTree(layers["down_split_dims"][0],
                            layers["down_thresholds"][0])
            self._keep_idx = P.plan_from_consumer_tree(
                tree, consumer_in_dim=self._cfg.d_ff).keep_idx
        return self._keep_idx

    def _record_projection(self, layer: int, tap: dict, mlp_inputs) -> None:
        from repro_torch.core import maddness as M
        from repro_torch.kernels import dispatch as D

        proj = tap["proj"]
        params = tap["params"]
        approx = tap["out"].to(torch.float32)

        # --- codebook utilisation + saturation (always available)
        xs = tap["x"].to(torch.float32)
        if proj == "down":
            xs = D._to_split_values(xs, params, tap["input_kind"])
        codes_t = M.encode(xs, params.tree).to(torch.int64)  # (B, C)
        codes = codes_t.cpu().numpy()
        tree_key = "down" if proj == "down" else "up"
        hits = self._hits.get((layer, tree_key))
        c, g = params.tree.num_codebooks, 2 ** params.tree.depth
        if hits is None:
            hits = np.zeros((c, g), np.int64)
            self._hits[(layer, tree_key)] = hits
        np.add.at(hits, (np.arange(c)[None, :].repeat(len(codes), 0), codes),
                  1)
        dead = int((hits == 0).sum())
        self.registry.gauge(
            "quality_dead_buckets",
            "Codebook buckets never selected by live traffic",
            layer=str(layer), tree=tree_key).set(dead)
        self.registry.gauge(
            "quality_bucket_utilisation",
            "Fraction of codebook buckets live traffic has selected",
            layer=str(layer), tree=tree_key).set(1.0 - dead / hits.size)

        lut = params.lut
        if lut.dtype == torch.int8:
            # int4 tables are stored as int8 in [-8, 7]
            int4 = int(lut.abs().max()) <= 8 if lut.numel() else True
            lo, hi = (-8, 7) if int4 else (-128, 127)
            resolution = "int4" if int4 else "int8"
            books = torch.arange(c, device=lut.device)[None, :]
            codes_d = codes_t.to(lut.device)
            sat = n = 0
            for r0 in range(0, codes_d.shape[0], _SAT_ROWS):
                gathered = lut[books, codes_d[r0:r0 + _SAT_ROWS]]  # (b, C, N)
                sat += int(((gathered == lo) | (gathered == hi)).sum())
                n += gathered.numel()
            self.registry.counter(
                "quality_lookups_total", "LUT entries gathered by probes",
                layer=str(layer), proj=proj).inc(n)
            if sat:
                self.registry.counter(
                    "quality_saturated_lookups_total",
                    "Gathered LUT entries at the quantisation extremes",
                    layer=str(layer), proj=proj,
                    resolution=resolution).inc(sat)

        # --- relative error vs the dense reference (needs dense weights)
        xt = mlp_inputs[layer].to(torch.float32)
        if proj in ("gate", "up"):
            w = self._dense_w(layer, f"w_{proj}")
            if w is None:
                return
            ref = xt @ w.to(xt.device)
            if ref.shape[-1] != approx.shape[-1]:
                ref = ref[:, self._keep_columns().to(ref.device)]
        else:  # down: whole-layer reference on the same layer input
            ws = [self._dense_w(layer, n)
                  for n in ("w_gate", "w_up", "w_down")]
            if any(w is None for w in ws):
                return
            wg, wu, wd = (w.to(xt.device) for w in ws)
            ref = (F.silu(xt @ wg) * (xt @ wu)) @ wd
            approx = approx.reshape(ref.shape)
        num = torch.linalg.vector_norm(approx - ref, dim=-1)
        den = torch.linalg.vector_norm(ref, dim=-1) + 1e-9
        h = self.registry.histogram(
            "quality_rel_error",
            "Per-token relative error of the LUT-MU path vs the dense "
            "reference on identical activations",
            buckets=REL_ERROR_BUCKETS, layer=str(layer), proj=proj)
        for v in (num / den).cpu().tolist():
            h.observe(v)

    # -- snapshot (the /debug/quality endpoint) ------------------------------
    def snapshot(self) -> dict:
        reg = self.registry
        layers: Dict[str, dict] = {}
        for m in reg.find("quality_rel_error"):
            lab = dict(m.labels)
            if not m.count:
                continue
            entry = layers.setdefault(lab["layer"], {})
            entry.setdefault("rel_error", {})[lab["proj"]] = {
                "mean": m.mean, "p50": m.quantile(0.5),
                "p99": m.quantile(0.99), "n": m.count}
        for (layer, tree), hits in sorted(self._hits.items()):
            entry = layers.setdefault(str(layer), {})
            entry.setdefault("buckets", {})[tree] = {
                "dead": int((hits == 0).sum()), "total": int(hits.size)}
        saturation = {}
        for m in reg.find("quality_saturated_lookups_total"):
            lab = dict(m.labels)
            denom = reg.value("quality_lookups_total", layer=lab["layer"],
                              proj=lab["proj"])
            saturation[f"{lab['layer']}/{lab['proj']}"] = {
                "resolution": lab["resolution"], "saturated": m.value,
                "lookups": denom,
                "fraction": m.value / denom if denom else 0.0}
        return {
            "enabled": True,
            "rate": self.rate,
            "max_tokens": self.max_tokens,
            "dense_reference": self._dense is not None,
            "supported": self._supported,
            "probes": reg.value("quality_probes_total"),
            "probe_tokens": reg.value("quality_probe_tokens_total"),
            "probe_errors": reg.value("quality_probe_errors_total"),
            "layers": layers,
            "saturation": saturation,
            "acceptance_drift": reg.value("slo_acceptance_drift"),
        }
