"""Bytes uploaded to the device per byte of capture used: Σ ``h2d_bytes``
over Σ ``input_bytes`` (valid frames times bytes per frame) of the
``iq2a.stage`` spans."""

from portbench.harness.spans import counter_ratio


def read(run):
    return counter_ratio(run, "h2d_bytes", "input_bytes")
