"""Monitor side of the port: so far the ``MonMap`` (``mon/monmap.py``).
The JAX package's ``Monitor`` is not ported yet."""
