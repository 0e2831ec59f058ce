"""One file per public entry of the program that a job calls, found by the
traffic file's ``entry``: ``<entry>.py`` with ``run(config, traffic)``,
which makes one call in a fresh pipeline and returns the program's
``ProcessingResult``."""
