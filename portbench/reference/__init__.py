"""The benchmark's plain reference: `dex` (a frozen copy of the program's
plain path) and `judge` (the comparisons that decide `correct`)."""
