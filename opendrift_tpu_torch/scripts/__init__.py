"""Command-line scripts of the port, each run as
``python -m opendrift_tpu_torch.scripts.<name> ... [--device DEVICE]``
(``cuda`` unless ``--device cpu``): ``opendrift_plot``, ``opendrift_animate``,
``readerinfo``, ``hodograph`` and ``gui``.  ``data_sources.txt`` lists the
default forcing sources (``OpenDriftSimulation.default_readers``)."""
