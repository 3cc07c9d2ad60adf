"""HDF5 / numpy type tables for the FLASH file format.

FLASH parameter tables ("real scalars", "integer runtime parameters", ...)
are HDF5 compound datasets of (name: 256-char string, value). These dtype
specs let us read and write files the FLASH tooling understands
(reference: fava/util/_types.py:5-41).
"""

import numpy as np


class HDF5_TYPES:
    """Type names / compound dtype specs used when writing FLASH files."""

    F32 = "<f4"
    F64 = "<f8"
    I32 = "<i4"
    I64 = "<i8"

    # Compound (name, value) parameter-table records.
    F64_PARAMETER = [("name", "S256"), ("value", "<f8")]
    I32_PARAMETER = [("name", "S256"), ("value", "<i4")]
    BOOL_PARAMETER = [("name", "S256"), ("value", "<i4")]
    STR_PARAMETER = [("name", "S256"), ("value", "S256")]

    # 4-character field names in the "unknown names" dataset.
    UNKNOWN_NAMES = "S4"


HID_T = HDF5_TYPES()


class NUMPY_TYPES:
    FLOAT32 = np.dtype(np.float32)
    FLOAT64 = np.dtype(np.float64)
    INT32 = np.dtype(np.int32)
    INT64 = np.dtype(np.int64)


NP_T = NUMPY_TYPES()
