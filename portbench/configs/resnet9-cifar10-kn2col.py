"""ResNet-9 on CIFAR-10-sized images with Kn2col LUT-MU convolutions (the
paper's case study, §VI-B), at ``resnet9-cifar10-kn2col.json``'s widths.

The inputs are the benchmark's: ``make_params`` draws conv0, the head and
every tap's tree and int8 table on the device from the seed, with no fit:
each tap's thresholds are the medians of its own inputs at each node, from
seeded calibration images run through the layers before it (the
reference's forward), so the leaves are used about as a fit would use
them.  ``program_forward`` builds the port's ``AMMLinear`` taps from the
same tensors through its public constructors.
"""
from __future__ import annotations

import json
import math
from functools import partial
from pathlib import Path
from typing import Callable, Dict

import torch

from portbench.counts import resnet9_convs
from portbench.reference import maddness as MR
from portbench.reference import resnet9_kn2col as RR

DRIVER = "images"
REFERENCE = "resnet9_kn2col"
SOURCE = "https://arxiv.org/abs/2407.02362"
REDUCED: tuple = ()
SIZES: Dict = json.loads(Path(__file__).with_suffix(".json").read_text())
ASSUMED = SIZES["assumed"]
INT8_STD = 73.9
CALIB_IMAGES = 32
CALIB_ROWS = 4096  # rows of a tap's input its medians are taken over


def tree_thresholds(xs: torch.Tensor) -> torch.Tensor:
    """Heap-ordered thresholds ``(C, 2**I - 1)`` of balanced trees over
    split values ``xs (R, C, I)``: each node's threshold is the median of
    the values its rows compare there (0 where no row reaches it)."""
    r, c, depth = xs.shape
    thr = torch.zeros((c, 2 ** depth - 1), dtype=torch.float32,
                      device=xs.device)
    cols = torch.arange(c, device=xs.device)[None].expand(r, c)
    node = torch.zeros((r, c), dtype=torch.int64, device=xs.device)
    nan = torch.full_like(xs[:, :, 0], float("nan"))
    for level in range(depth):
        vals = xs[:, :, level]
        for heap in range(2 ** level - 1, 2 ** (level + 1) - 1):
            med = torch.nanmedian(torch.where(node == heap, vals, nan), dim=0)
            thr[:, heap] = torch.nan_to_num(med.values, nan=0.0)
        node = 2 * node + 1 + (vals >= thr[cols, node]).to(torch.int64)
    return thr


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """conv0, the head and its bias, and the nine taps of every LUT-MU
    layer, from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    c = sizes["channels"]
    h, w, cin0 = sizes["image"]
    lm = sizes["lutmu"]
    d_sub, depth = lm["d_sub"], lm["depth"]
    g = 2 ** depth
    params = {
        "conv0": torch.randn((3, 3, cin0, c[0]), generator=gen,
                             device=device) / math.sqrt(9 * cin0),
        "head": torch.randn((c[-1], sizes["num_classes"]), generator=gen,
                            device=device) / math.sqrt(c[-1]),
        "head_b": torch.zeros((sizes["num_classes"],), device=device),
        "taps": {},
    }
    calib = torch.randn((CALIB_IMAGES, h, w, cin0), generator=gen,
                        device=device)
    for name in RR.LAYERS:
        if name in sizes["exact_layers"]:
            continue
        x = RR.forward(params, calib, stop_at=name)
        b, hh, ww, cin = x.shape
        cout = resnet9_convs(sizes)[name][3]
        nc = cin // d_sub
        scale = float(x.pow(2).mean().sqrt()) / (3 * INT8_STD * math.sqrt(nc))
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        taps = []
        for t in range(9):
            ky, kx = divmod(t, 3)
            rows = xp[:, ky:ky + hh, kx:kx + ww].reshape(-1, cin)
            pick = torch.randperm(rows.shape[0], generator=gen,
                                  device=device)[:CALIB_ROWS]
            sd = torch.randint(0, d_sub, (nc, depth), generator=gen,
                               dtype=torch.int32, device=device)
            taps.append({
                "split_dims": sd,
                "thresholds": tree_thresholds(
                    MR.gather_split_values(rows[pick], sd)),
                "lut": torch.randint(-128, 128, (nc, g, cout), generator=gen,
                                     dtype=torch.int8, device=device),
                "scale": torch.full((cout,), scale, device=device),
                "offset": torch.zeros((cout,), device=device),
            })
        params["taps"][name] = taps
    return params


def make_images(sizes: Dict, seed: int, n_batches: int, batch: int, device
                ) -> torch.Tensor:
    """The image pool ``(n_batches, batch, H, W, 3)`` of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return torch.randn((n_batches, batch, *sizes["image"]), generator=gen,
                       device=device)


def program_forward(params: Dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """The port's ResNet-9 forward over ``params``: ``resnet9_forward`` with
    Kn2col conv functions whose taps are ``AMMLinear`` units built from the
    benchmark's tensors."""
    from repro_torch.core import conv as CV
    from repro_torch.core.lut_mu import AMMLinear
    from repro_torch.core.maddness import HashTree, MaddnessParams
    from repro_torch.models.cnn import resnet9_forward

    conv_fns, port = {}, {"conv0": params["conv0"], "head": params["head"],
                          "head_b": params["head_b"]}
    for name, taps in params["taps"].items():
        units = [AMMLinear(params=MaddnessParams(
                    HashTree(t["split_dims"], t["thresholds"]), None, t["lut"],
                    t["scale"], t["offset"]),
                 out_plan=None, full_out_features=t["lut"].shape[-1])
                 for t in taps]
        conv_fns[name] = partial(
            CV.conv_kn2col,
            tap_matmuls=[lambda a, u=u: u(a, backend="auto") for u in units])
        # conv_kn2col reads only the kernel size off the weight it is given
        port[name] = torch.zeros((), device=params["conv0"].device).expand(
            3, 3, 1, 1)
    return lambda x: resnet9_forward(port, x, conv_fns)
