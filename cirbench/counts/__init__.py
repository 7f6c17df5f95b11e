"""Operation and byte counts as functions of shapes alone, and the table of
the chip's peaks. The MFU and roofline readers divide these by times."""
