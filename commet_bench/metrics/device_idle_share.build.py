"""Percent of the traced window in which the device ran no kernel, copy or
set."""

from commet_bench import layers


def read(run):
    return layers.device_idle_share(run)
