"""Process-wide settings of the port (a stand-in for the JAX package's
``common/``, holding only what the ported modules read)."""
