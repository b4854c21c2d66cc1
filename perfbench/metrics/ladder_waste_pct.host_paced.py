"""``ladder_waste_pct``, read in a host-paced cell, where it moves ``sort_p95_ms.host_paced``."""
from perfbench import manifest

read = manifest.reader("ladder_waste_pct")
