"""Skeleton mesh loading from the Geometry folder (OBJ / ascii-PLY).

Capability parity: NimbleGUI's ``renderSkeleton`` drew OpenSim body
meshes resolved from the Geometry folder (reference visualize.py:123-263
via ``readSkel(pass, geometry_folder)``). The rebuild parses the mesh
files directly (stdlib only) and hands decimated wireframes to the live
viewer, which transforms them by each body's FK world transform.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Wireframe = Tuple[np.ndarray, np.ndarray]  # verts [N,3], edges [E,2] int


def parse_obj(path: str) -> Wireframe:
    verts: List[List[float]] = []
    edges = set()
    with open(path, 'r', errors='replace') as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'v' and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == 'f' and len(parts) >= 4:
                idx = [int(p.split('/')[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for a, b in zip(idx, idx[1:] + idx[:1]):
                    edges.add((min(a, b), max(a, b)))
    return (np.asarray(verts, np.float32),
            np.asarray(sorted(edges), np.int32).reshape(-1, 2))


def parse_ply_ascii(path: str) -> Wireframe:
    with open(path, 'r', errors='replace') as f:
        if f.readline().strip() != 'ply':
            raise ValueError(f'{path}: not a PLY file')
        n_verts = n_faces = 0
        fmt_ok = False
        vert_props = 0
        in_vertex_element = False
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == 'format':
                fmt_ok = t[1] == 'ascii'
            elif t[0] == 'element':
                in_vertex_element = t[1] == 'vertex'
                if t[1] == 'vertex':
                    n_verts = int(t[2])
                elif t[1] == 'face':
                    n_faces = int(t[2])
            elif t[0] == 'property' and in_vertex_element:
                vert_props += 1
            elif t[0] == 'end_header':
                break
        if not fmt_ok:
            raise ValueError(f'{path}: only ascii PLY supported')
        verts = np.zeros((n_verts, 3), np.float32)
        for i in range(n_verts):
            vals = f.readline().split()
            verts[i] = [float(vals[0]), float(vals[1]), float(vals[2])]
        edges = set()
        for _ in range(n_faces):
            vals = [int(v) for v in f.readline().split()]
            idx = vals[1:1 + vals[0]]
            for a, b in zip(idx, idx[1:] + idx[:1]):
                edges.add((min(a, b), max(a, b)))
    return verts, np.asarray(sorted(edges), np.int32).reshape(-1, 2)


def decimate(wf: Wireframe, max_edges: int = 600) -> Wireframe:
    """Keep at most `max_edges` edges (uniform subsample) and compact the
    vertex array to the vertices those edges reference."""
    verts, edges = wf
    if len(edges) > max_edges:
        keep = np.linspace(0, len(edges) - 1, max_edges).astype(int)
        edges = edges[keep]
    used = np.unique(edges.reshape(-1)) if len(edges) else np.zeros(0, np.int64)
    remap = np.zeros(len(verts), np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return verts[used], remap[edges] if len(edges) else edges


def load_mesh(path: str) -> Optional[Wireframe]:
    try:
        if path.endswith('.obj'):
            return parse_obj(path)
        if path.endswith('.ply'):
            return parse_ply_ascii(path)
    except Exception:
        return None
    return None


def load_body_meshes(geometry_folder: str, body_names: Sequence[str],
                     max_edges: int = 600) -> Dict[str, Wireframe]:
    """Match each body to a mesh file by name stem (``femur_l`` also tries
    ``femur``, stripping the side suffix) and return decimated wireframes."""
    if not geometry_folder or not os.path.isdir(geometry_folder):
        return {}
    files: Dict[str, str] = {}
    for f in sorted(os.listdir(geometry_folder)):
        stem, ext = os.path.splitext(f)
        if ext in ('.obj', '.ply') and stem.lower() not in files:
            files[stem.lower()] = os.path.join(geometry_folder, f)
    out: Dict[str, Wireframe] = {}
    for body in body_names:
        lower = body.lower()
        candidates = [lower]
        for suffix in ('_l', '_r'):
            if lower.endswith(suffix):
                candidates.append(lower[:-2])
        path = next((files[c] for c in candidates if c in files), None)
        if path:
            mesh = load_mesh(path)
            if mesh is not None and len(mesh[0]):
                verts, edges = decimate(mesh, max_edges)
                # mirror side-shared meshes for left bodies (OpenSim
                # convention: geometry authored for the right side)
                if lower.endswith('_l') and not os.path.basename(
                        path).lower().startswith(lower):
                    verts = verts * np.array([1.0, 1.0, -1.0], np.float32)
                out[body] = (verts, edges)
    return out
