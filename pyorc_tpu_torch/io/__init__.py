"""IO backends: netCDF-4 over h5py."""

from .netcdf import read_netcdf, write_netcdf

__all__ = ["read_netcdf", "write_netcdf"]
