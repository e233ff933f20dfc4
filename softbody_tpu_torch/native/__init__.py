"""Native host helpers built at first use (g++ / ctypes)."""
