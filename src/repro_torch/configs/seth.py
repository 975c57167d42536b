"""Seth — the paper's case-study system (Fig. 7) and its WMS setup.

Seth (HPC2N, SNIC): 120 nodes × 4 cores × 1 GB ≈ 480 cores / 120 GB.
This is the `+ paper's own` config: not an LM architecture but the
synthetic HPC system the paper's experiments run on.
"""

SYSTEM = {
    "groups": {"seth": {"core": 4, "mem": 1024}},
    "nodes": {"seth": 120},
}

# paper §6.2 software versions (documentation of the reproduced setup)
PAPER_SETUP = {
    "accasim": "1.0",
    "python": "3.6.5",
    "workloads": {
        "seth": {"jobs": 202_871, "span": "2002-07..2006-01"},
        "ricc": {"jobs": 447_794, "span": "2010-05..2010-09"},
        "metacentrum": {"jobs": 5_731_100, "span": "2013-01..2015-04"},
    },
}


def resource_manager():
    from ..core.resources import ResourceManager
    return ResourceManager(SYSTEM)
