"""Share of the capture bytes used that the reader read straight into a
pinned upload slot, in %: 100 x Σ ``direct_bytes`` (the ``iq2a.read``
spans that filled a slot's row) over Σ ``input_bytes`` (valid frames times
bytes per frame, of the ``iq2a.stage`` spans).  The rest is the warm-up's
first block, copied in.  A program without the counter gives None."""

from portbench.harness.spans import counter_ratio


def read(run):
    # counter_ratio gives None where a counter sums to 0: here, where the
    # program counts no direct reads
    if counter_ratio(run, "direct_bytes", "direct_bytes") is None:
        return None
    share = counter_ratio(run, "direct_bytes", "input_bytes")
    return None if share is None else 100.0 * share
