"""qwen3-14b with every MLP a pruned int8 LUT-MU chain, at its published
widths and depth (``qwen3-14b-lutmu.json``), served through the port's
paged engine.

The inputs are the benchmark's: ``make_params`` draws every weight and
table on the device from the seed, one call per stacked leaf, in the
port's params layout (the JAX layout: dense weights ``(D_in, D_out)``,
layers stacked on a leading axis, the LUT-MU tables under
``layers/amm_mlp``), and the same tensors go to the engine and to the
reference.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict

import torch

DRIVER = "serve"
REFERENCE = "qwen3_lutmu"
SOURCE = "https://huggingface.co/Qwen/Qwen3-14B"
REDUCED: tuple = ()
SIZES: Dict = json.loads(Path(__file__).with_suffix(".json").read_text())
ASSUMED = SIZES["assumed"]
INT8_STD = 73.9          # std of a uniform int8 in [-128, 127]
THRESHOLD_STD = 0.05
OFFSET_STD = 0.02


def model_config(sizes: Dict = SIZES):
    """The port's ``ModelConfig`` of ``sizes``: its registry entry with the
    sizes' widths and depth, LUT-MU MLPs on."""
    from repro_torch.configs import get_config
    base = get_config(sizes["registry"])
    lm = sizes["lutmu"]
    return dataclasses.replace(
        base, num_layers=sizes["num_hidden_layers"],
        d_model=sizes["hidden_size"], num_heads=sizes["num_attention_heads"],
        num_kv_heads=sizes["num_key_value_heads"],
        d_ff=sizes["intermediate_size"], vocab_size=sizes["vocab_size"],
        head_dim=sizes["head_dim"], qk_norm=True,
        rope_theta=float(sizes["rope_theta"]), norm_eps=sizes["rms_norm_eps"],
        amm=dataclasses.replace(base.amm, enabled=True, backend=lm["backend"],
                                d_sub=lm["d_sub"], depth=lm["depth"],
                                quantize_int8=True, prune=lm["prune"],
                                targets=tuple(lm["targets"]), kv_int8=False))


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """Every weight and table of the model from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bf16, f32 = torch.bfloat16, torch.float32
    n_l, d, v = (sizes["num_hidden_layers"], sizes["hidden_size"],
                 sizes["vocab_size"])
    nq, nkv, hd = (sizes["num_attention_heads"], sizes["num_key_value_heads"],
                   sizes["head_dim"])
    lm = sizes["lutmu"]
    depth, g = lm["depth"], 2 ** lm["depth"]
    c_up, c_down = d // lm["d_sub"], sizes["intermediate_size"] // lm["d_sub"]
    cols = depth * c_down  # the pruned package the down tables read

    def normal(shape, std, dtype=bf16):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(std)

    def zeros(shape, dtype=bf16):
        return torch.zeros(shape, dtype=dtype, device=device)

    def table(c, n):
        return torch.randint(-128, 128, (n_l, c, g, n), generator=gen,
                             dtype=torch.int8, device=device)

    def split_dims(c):
        return torch.randint(0, lm["d_sub"], (n_l, c, depth), generator=gen,
                             dtype=torch.int32, device=device)

    def scale(c, n):
        return torch.full((n_l, n), 1.0 / (INT8_STD * math.sqrt(c)),
                          dtype=f32, device=device)

    return {
        "embed": normal((v, d), 0.02),
        "final_norm": zeros((d,)),
        "lm_head": normal((d, v), d ** -0.5),
        "layers": {
            "ln1": zeros((n_l, d)),
            "attn": {"wq": normal((n_l, d, nq * hd), d ** -0.5),
                     "wk": normal((n_l, d, nkv * hd), d ** -0.5),
                     "wv": normal((n_l, d, nkv * hd), d ** -0.5),
                     "wo": normal((n_l, nq * hd, d), (nq * hd) ** -0.5),
                     "q_norm": zeros((n_l, hd)), "k_norm": zeros((n_l, hd))},
            "ln2": zeros((n_l, d)),
            "amm_mlp": {
                "up_split_dims": split_dims(c_up),
                "up_thresholds": normal((n_l, c_up, g - 1), THRESHOLD_STD, f32),
                "lut_gate": table(c_up, cols),
                "lut_gate_scale": scale(c_up, cols),
                "lut_gate_offset": normal((n_l, cols), OFFSET_STD, f32),
                "lut_up": table(c_up, cols),
                "lut_up_scale": scale(c_up, cols),
                "lut_up_offset": normal((n_l, cols), OFFSET_STD, f32),
                "down_split_dims": split_dims(c_down),
                "down_thresholds": normal((n_l, c_down, g - 1), THRESHOLD_STD, f32),
                "lut_down": table(c_down, d),
                "lut_down_scale": scale(c_down, d),
                "lut_down_offset": normal((n_l, d), OFFSET_STD, f32),
            },
        },
    }
