"""Seeded synthetic captures, one module per signal model: ``<name>.py`` with
``make(cfg, seconds, seed, device) -> complex tensor`` and ``offsets(cfg)``."""
