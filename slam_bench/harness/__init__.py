"""The benchmark's general code: configurations as data, what the drivers
share, the traced stretch, the arithmetic and the check against the
reference."""
