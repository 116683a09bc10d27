from .io_netcdf import write_result, read_result  # noqa: F401
