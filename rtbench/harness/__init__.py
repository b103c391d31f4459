"""The benchmark's harness: cells from data, the program's passes, the
window, the traced slice and the check."""
