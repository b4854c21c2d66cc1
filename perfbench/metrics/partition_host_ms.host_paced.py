"""``partition_host_ms``, read in a host-paced cell, where it moves ``keys_per_s.host_paced``."""
from perfbench import manifest

read = manifest.reader("partition_host_ms")
