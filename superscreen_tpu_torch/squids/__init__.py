"""Layouts of real SQUID susceptometers (host geometry) and the
pickup-loop / field-coil mutual-inductance workload on them."""

from . import huber, hypres, ibm
from .layers import hypres_squid_layers, ibm_squid_layers
from .mutuals import (
    MAX_EDGE_LENGTHS,
    SQUID_LAYOUTS,
    compute_mutuals,
    pickup_loop_mutual,
)
from .susceptometer import (
    SQUID_PRESETS,
    SusceptometerGeometry,
    loop_with_leads,
    make_squid,
    squid_mutual_inductance,
)
