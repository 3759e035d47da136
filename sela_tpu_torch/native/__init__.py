"""Native host libraries of the port (C++, ctypes)."""
