"""GF(2^8) tables and coding matrices (host numpy)."""
