"""The SFC/MNIST case study in the PyTorch port (the twin of
``train_mnist_mlp.py``): train an MLP on synthetic MNIST, compile pruned
LUT-MU chains for every matmul, retrain their LUTs layer by layer, and
compare accuracy, footprint and workload (the paper's Fig. 10 / Table I).

Run:  PYTHONPATH=src python examples/torch_train_mnist_mlp.py [--device cpu]
"""
import argparse

from repro_torch.core import lut_mu as LM
from repro_torch.data import synthetic_mnist
from repro_torch.models import cnn

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' runs the kernels' "
                     "plain versions)")
ap.add_argument("--retrain-steps", type=int, default=150)
args = ap.parse_args()

x, y = synthetic_mnist(4096, seed=0)
xt, yt = x[3072:], y[3072:]
x, y = x[:3072], y[:3072]

cfg = cnn.MLPConfig(sizes=(784, 128, 128, 10))
print(f"training exact MLP (784-128-128-10) on synthetic MNIST on "
      f"{args.device} …")
params = cnn.mlp_train(cfg, x, y, steps=300, lr=0.1, device=args.device)
n_layers = len(cfg.sizes) - 1
exact_acc = cnn.mlp_accuracy(lambda xb: cnn.mlp_forward(params, xb, n_layers),
                         xt, yt, device=args.device)
print(f"exact accuracy:      {exact_acc:.3f}")
weights = [params[f"w{i}"] for i in range(n_layers)]
biases = [params[f"b{i}"] for i in range(n_layers)]

for cbs, dps, tag in (
    ((98, 16, 16), (4, 4, 4), "high-res first layer (C=98)"),
    ((49, 16, 16), (4, 4, 4), "low-res first layer (C=49)"),
):
    chain = cnn.mlp_to_amm(params, cfg, x[:1024], num_codebooks=cbs,
                           depths=dps)
    acc = cnn.mlp_accuracy(lambda xb: chain(xb), xt, yt, device=args.device)
    retrained = LM.retrain_chain(chain, weights, biases, x[:1024],
                                 steps=args.retrain_steps)
    racc = cnn.mlp_accuracy(lambda xb: retrained(xb), xt, yt, device=args.device)
    unpruned = LM.unpruned_chain(chain, weights, biases)
    print(f"LUT-MU {tag}: acc {acc:.3f} (retrained {racc:.3f})  "
          f"LUT bytes {chain.lut_bytes()} (unpruned {unpruned.lut_bytes()}, "
          f"saving {unpruned.lut_bytes() / chain.lut_bytes():.2f}x)  "
          f"workload {chain.workload_ops()} ops/row "
          f"(exact {sum(2 * cfg.sizes[i] * cfg.sizes[i + 1] for i in range(n_layers))})")
