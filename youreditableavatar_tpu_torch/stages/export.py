"""Mesh exporters: the file-mediated inter-stage interface.

Counterpart of `youreditableavatar_tpu/stages/export.py` (numpy, the same
code; a mesh's tensors are read back to the host first). After the
reference exporters, keeping identical `.npy`
schemas so artifacts are drop-in compatible (`SURVEY.md` §5.4):

  * `export_init_mesh` (= `mesh-exporter-init`, `mesh_exporter_init.py:47-86`):
    `init_mesh.npy` = {"mesh": {vertices, faces, face_to_global_tet_idx}}.
  * `export_edit_mesh` (= `mesh-exporter-part`, `mesh_exporter_part.py:56-192`):
    `edit_mesh.npy` = {"mesh": {vertices, faces, face_to_global_tet_idx,
    keep_vertices_num, keep_faces_num, editing_mask}} where the mesh is
    keep ∥ edit concatenated and the per-vertex editing mask marks kept edit
    vertices after floater removal.
  * `export_editing_region_info` (= `mesh_localization.py:169-199`):
    {"editing_mask": per-vertex, "editing_mask_faces": per-face} 0/1 arrays.

Floater removal (`pymeshlab meshing_remove_connected_component_by_face_number`,
`mesh_exporter_part.py:164-172`) is re-implemented as a host-side
connected-component sweep over the face adjacency graph (components smaller
than 10% of the face count are dropped) — with vertex-id bookkeeping instead
of the reference's float-coordinate set matching.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from youreditableavatar_tpu_torch.ops.marching_tets import MTOutput


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a tensor, possibly on the card
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compact_mt(mesh: MTOutput) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Budgeted MT output → dense (verts, faces, face_to_tet) numpy arrays."""
    nv = int(mesh.num_verts)
    nf = int(mesh.num_faces)
    valid = _host(mesh.faces_valid)
    verts = _host(mesh.verts)[:nv]
    faces = _host(mesh.faces)[valid][:nf]
    f2t = _host(mesh.face_to_tet)[valid][:nf]
    return verts, faces, f2t


def face_components(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Connected components over the face graph (shared-vertex adjacency).

    Returns (F,) component id per face, numbered in order of each
    component's smallest vertex (the JAX package numbers them by its
    union-find roots: the same partition, ids permuted). The vertices'
    components come from `scipy.sparse.csgraph.connected_components`
    over each face's two edges from its first vertex.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    f = np.asarray(faces, np.int64)
    if len(f) == 0:
        return np.zeros((0,), np.int64)
    rows = np.concatenate([f[:, 0], f[:, 0]])
    cols = np.concatenate([f[:, 1], f[:, 2]])
    graph = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                       shape=(num_verts, num_verts))
    _, labels = connected_components(graph, directed=False)
    _, comp = np.unique(labels[f[:, 0]], return_inverse=True)
    return comp


def remove_floaters(
    verts: np.ndarray, faces: np.ndarray, min_fraction: float = 0.1
) -> np.ndarray:
    """(F,) bool mask of faces kept: components ≥ min_fraction of all faces."""
    if len(faces) == 0:
        return np.zeros((0,), bool)
    comp = face_components(faces, len(verts))
    return np.bincount(comp)[comp] >= max(1, int(len(faces) * min_fraction))


def export_init_mesh(
    path: str,
    mesh: MTOutput,
    convert_fn=None,
) -> Dict:
    """Write `init_mesh.npy` (schema of `mesh_exporter_init.py:56-70`)."""
    verts, faces, f2t = compact_mt(mesh)
    if convert_fn is not None:
        verts = convert_fn(verts)
    data = {
        "mesh": {
            "vertices": verts.astype(np.float64),
            "faces": faces.astype(np.int64),
            "face_to_global_tet_idx": f2t.astype(np.int64),
        }
    }
    np.save(path, data)  # dict payload (allow_pickle on load), as reference
    return data


def export_edit_mesh(
    path: str,
    keep_mesh: MTOutput,
    edit_mesh: MTOutput,
    convert_fn=None,
    floater_min_fraction: float = 0.1,
) -> Dict:
    """Write `edit_mesh.npy` (schema of `mesh_exporter_part.py:174-191`)."""
    kv, kf, kf2t = compact_mt(keep_mesh)
    ev, ef, ef2t = compact_mt(edit_mesh)

    keep_faces_mask = remove_floaters(ev, ef, floater_min_fraction)
    ef_clean = ef[keep_faces_mask]
    ef2t_clean = ef2t[keep_faces_mask]
    # Per-vertex edit mask: edit vertices still referenced after cleanup.
    edit_vert_kept = np.zeros(len(ev), bool)
    edit_vert_kept[np.unique(ef_clean)] = True

    vertices = np.concatenate([kv, ev])
    faces = np.concatenate([kf, ef_clean + len(kv)])
    f2t = np.concatenate([kf2t, ef2t_clean])
    editing_mask = np.concatenate(
        [np.zeros(len(kv), np.int64), edit_vert_kept.astype(np.int64)]
    )
    if convert_fn is not None:
        vertices = convert_fn(vertices)
    data = {
        "mesh": {
            "vertices": vertices.astype(np.float64),
            "faces": faces.astype(np.int64),
            "face_to_global_tet_idx": f2t.astype(np.int64),
            "keep_vertices_num": len(kv),
            "keep_faces_num": len(kf),
            "editing_mask": editing_mask,
        }
    }
    np.save(path, data)
    return data


def export_editing_region_info(
    path: str,
    vertex_mask: np.ndarray,
    face_mask: np.ndarray,
) -> Dict:
    """Write `editing_region_info.npy` (`mesh_localization.py:196-199`)."""
    info = {
        "editing_mask": np.asarray(vertex_mask).astype(np.int64),
        "editing_mask_faces": np.asarray(face_mask).astype(np.float64),
    }
    np.save(path, info)
    return info


def load_init_mesh(path: str) -> Dict:
    return np.load(path, allow_pickle=True).item()["mesh"]


def load_edit_mesh(path: str) -> Dict:
    return np.load(path, allow_pickle=True).item()["mesh"]


def load_editing_region_info(path: str) -> Dict:
    return np.load(path, allow_pickle=True).item()
