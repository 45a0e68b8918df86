"""Command-line tools of the port: ``crushtool``, ``osdmaptool``,
``dencoder``, ``ec_benchmark``, ``rados``, ``rados_bench``, ``ceph_cli``,
``psim``, and the offline ones ``authtool``, ``monmaptool``,
``ceph_conf``, ``kvstore_tool``, ``monstore_tool``, ``objectstore_tool``
and ``rebuild_mondb``."""
