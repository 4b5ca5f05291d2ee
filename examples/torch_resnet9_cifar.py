"""The ResNet-9/CIFAR case study in the PyTorch port (the twin of
``resnet9_cifar.py``): train a ResNet-9 on synthetic CIFAR, replace interior
convolutions with Kn2col LUT-MUs (pruning-friendly) and with Im2col
(the original Halutmatmul), and compare accuracy and footprint (the paper's
Fig. 9).

Run:  PYTHONPATH=src python examples/torch_resnet9_cifar.py [--device cpu]
      (``--channels 64 128 256 512`` for the published widths, on the card)
"""
import argparse

from repro_torch.data import synthetic_cifar
from repro_torch.models import cnn

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' runs the kernels' "
                     "plain versions)")
ap.add_argument("--channels", type=int, nargs=4, default=[8, 16, 16, 32])
args = ap.parse_args()

x, y = synthetic_cifar(768, seed=0)
xt, yt = x[512:], y[512:]
x, y = x[:512], y[:512]

cfg = cnn.ResNet9Config(channels=tuple(args.channels))
print(f"training ResNet-9 {cfg.channels} on synthetic CIFAR on "
      f"{args.device} …")
params = cnn.resnet9_train(cfg, x, y, steps=80, batch=32, device=args.device)
base_acc = cnn.mlp_accuracy(lambda b: cnn.resnet9_forward(params, b), xt, yt,
                        device=args.device)
print(f"exact accuracy: {base_acc:.3f}")

for mode, d_sub in (("kn2col", 8), ("im2col", 9)):
    conv_fns, fitted = cnn.resnet9_amm_conv_fns(
        params, x[:64], mode=mode, d_sub=d_sub, layers=["res1a", "res1b"])
    acc = cnn.mlp_accuracy(lambda b: cnn.resnet9_forward(params, b, conv_fns),
                       xt, yt, device=args.device)
    byts = sum(l.lut_bytes() for taps in fitted.values() for l in taps)
    print(f"{mode} LUT-MU (res1a/res1b substituted): acc {acc:.3f}, "
          f"LUT bytes {byts}"
          + ("  → chain-prunable (split dims concentrated per channel)"
             if mode == "kn2col" else
             "  → pruning infeasible (split dims scattered, paper §V-A4)"))
