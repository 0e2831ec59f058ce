"""The channelizer kernel's share of its roofline.

The bound counts the work any channelizer must do for the samples the jobs
consumed, from the configuration's shapes alone: each complex input read
once at the codec's width, each channel-rate complex64 output written once
(bytes, over the HBM rate), and 8 FLOPs per complex tap per output per
channel in direct form (over the TF32 tensor-core rate, the highest dense
float32-operand rate).  The larger of the two is the least time; the
metric is that over the device time of the kernels named below, in the
traced window.  The line on standard error says which bound held.
"""

import sys

#: kernels of the channelizer, by a part of their name
KERNELS = ("poly_fir_kernel",)
#: bytes per complex input sample, by codec
CODEC_BYTES = {"pcm_s16le": 4, "pcm_u8": 2, "pcm_f32le": 8}


def channel_geometry(cfg):
    """Decimation and filter length by the upstream's rules, as the
    reference designs them."""
    from portbench.reference import design

    fs = float(cfg["sample_rate"])
    p = cfg["pipeline"]
    d, _ = design.decimation(fs, p["fs_ch_target"])
    return d, design.channel_taps(fs, p["bandwidth"], d).size


def work(cfg, input_samples, channels):
    """(bytes, flops) for ``input_samples`` complex inputs and ``channels``."""
    d, taps = channel_geometry(cfg)
    outputs = input_samples / d
    nbytes = input_samples * CODEC_BYTES[cfg["codec"]] + outputs * 8 * channels
    return nbytes, 8.0 * taps * outputs * channels


def read(run):
    from portbench.harness.tracing import kernel_seconds

    t = run.trace
    if t is None:
        return None
    launches, secs = kernel_seconds(t, KERNELS)
    if launches == 0 or secs <= 0:
        return None
    peaks = run.peaks.get(run.device_kind)
    if peaks is None:
        return None
    nbytes = flops = 0.0
    for j in run.jobs:
        b, f = work(run.config, j.input_samples, len(j.offsets))
        nbytes += b
        flops += f
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_flops = flops / peaks["tf32_flops"]
    bound = "bytes" if t_bytes >= t_flops else "operations"
    print(
        f"chan_roofline: {launches} launches, {secs:.6f} s; bound by {bound} "
        f"({t_bytes:.6f} s bytes, {t_flops:.6f} s operations)", file=sys.stderr,
    )
    return 100.0 * max(t_bytes, t_flops) / secs
