"""Entry points of the port that a traffic mix can drive (see harness)."""
