"""``exchange_ms``, read in a host-paced cell, where it moves ``keys_per_s.host_paced``."""
from perfbench import manifest

read = manifest.reader("exchange_ms")
