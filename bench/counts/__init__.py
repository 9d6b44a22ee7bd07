"""The yardstick: published H100 peaks, the least time a kernel's work
could take, and the operations a forward pass needs, from the sizes of a
configuration file alone (nothing of the program)."""
