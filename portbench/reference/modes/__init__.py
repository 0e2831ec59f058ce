"""One demodulator per mode, ``<mode>.py`` with ``demod(z, fs_ch, params, prec)``."""
