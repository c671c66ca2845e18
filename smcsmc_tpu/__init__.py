"""smcsmc_tpu: SMC² engine for demographic inference in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of
luntergroup/smcsmc: a particle filter over ancestral recombination graphs,
inferring population sizes, migration rates and recombination rates from
multiple whole-genome sequences via EM on lagged sufficient statistics.
"""

__version__ = "0.1.0"

from .demography import Demography, parse_scrm_args  # noqa: F401
from .pattern import parse_pattern, smc2_pattern_times  # noqa: F401
from .segio import SegData, read_seg, write_seg  # noqa: F401
