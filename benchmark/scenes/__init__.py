"""Scene recipes in plain numpy: the benchmark makes every input itself
and hands the same arrays to the port and to the plain reference
(``harness.world``).  A recipe is found by the name a configuration
gives under ``scene``."""
