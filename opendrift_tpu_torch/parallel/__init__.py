"""The parallel layer: particle sharding (``mesh``), forcing-grid domain
decomposition (``domain`` standalone, ``tiled`` in the engine) and runs
over several processes (``multihost``)."""
