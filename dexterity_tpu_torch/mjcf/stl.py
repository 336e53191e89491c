"""Minimal STL reader (binary and ASCII) returning vertex arrays (port of
dexterity_tpu/mjcf/stl.py, numpy only)."""

from __future__ import annotations

import struct

import numpy as np


def load_stl_vertices(path: str) -> np.ndarray:
  """Returns (n, 3) float64 unique vertices of an STL file."""
  with open(path, 'rb') as f:
    head = f.read(5)
    f.seek(0)
    if head == b'solid':
      # Could still be binary with a 'solid' header; try ASCII, fall back.
      try:
        return _load_ascii(path)
      except (ValueError, UnicodeDecodeError):
        pass
    return _load_binary(f.read())


def _load_binary(blob: bytes) -> np.ndarray:
  (ntri,) = struct.unpack('<I', blob[80:84])
  record = np.frombuffer(blob[84:84 + ntri * 50], dtype=np.uint8)
  record = record.reshape(ntri, 50)
  tri = record[:, 12:48].copy().view('<f4').reshape(ntri, 3, 3)
  verts = tri.reshape(-1, 3).astype(np.float64)
  return np.unique(verts, axis=0)


def _load_ascii(path: str) -> np.ndarray:
  verts = []
  with open(path, 'r') as f:
    for line in f:
      parts = line.split()
      if parts[:1] == ['vertex']:
        verts.append([float(x) for x in parts[1:4]])
  if not verts:
    raise ValueError(f'no vertices in {path}')
  return np.unique(np.asarray(verts, dtype=np.float64), axis=0)
