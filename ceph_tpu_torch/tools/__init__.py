"""Command-line tools of the port (``crushtool``, ``osdmaptool``,
``dencoder``, ``ec_benchmark``)."""
