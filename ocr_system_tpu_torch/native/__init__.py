"""Native host ops: connected components (``cc_label``) and the batch ink
walk (``ink_walk``), C++ built with g++ at first use (``build``) and
called through ctypes; ``plain`` holds their numpy/scipy versions."""
