"""roofline.cd_global (%, higher is better; device trace), layer kernels:
ku_torch/csrc/cd_gibbs.cu over cd_gibbs_chain.cuh. As roofline.cd_cluster,
for the global-route launches of kernel #1."""

import re

from kubench.harness.readers import cd_roofline

KERNEL = re.compile(r"\bcd_gibbs_kernel\b")


def read(run):
    return cd_roofline(run, "global", KERNEL)
