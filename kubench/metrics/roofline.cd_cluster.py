"""roofline.cd_cluster (%, higher is better; device trace), layer kernels:
ku_torch/csrc/cd_gibbs.cu over cd_cluster.cuh. The least time of the
window's cluster-route launches of kernel #1 (their operations at the dense
TF32 peak, or their bytes at the memory's bandwidth, the larger) over the
profiler's device time of those launches."""

import re

from kubench.harness.readers import cd_roofline

KERNEL = re.compile(r"\bcd_gibbs_cluster_kernel\b")


def read(run):
    return cd_roofline(run, "cluster", KERNEL)
