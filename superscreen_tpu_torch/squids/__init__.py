"""Layouts of real SQUID susceptometers (host geometry), the pickup-loop /
field-coil mutual-inductance workload on them, and scanning SQUID
susceptometry and magnetometry (:mod:`.scanning`)."""

from . import huber, hypres, ibm
from .layers import hypres_squid_layers, ibm_squid_layers
from .scanning import (
    applied_field_maps,
    build_scan_forward,
    magnetometry_scan,
    susceptibility_scan,
)
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
