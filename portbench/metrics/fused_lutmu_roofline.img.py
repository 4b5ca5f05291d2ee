"""fused_lutmu_roofline.img: the traced slice's fused_lutmu launches, sum of their bounds over sum of their device time, in %."""
from portbench.harness.readers import lutmu_roofline

LAYER = "kernels/fused_lutmu.py -> csrc/fused_lutmu.cu"
MOVES = "images_s"


def read(ctx):
    return lutmu_roofline(ctx)
