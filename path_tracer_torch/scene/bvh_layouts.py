"""Direction-ordered DFS layouts for stackless front-to-back traversal.

A copy of ``path_tracer_tpu/scene/bvh_layouts.py`` (numpy only), so that
the port builds the superleaf tree walk's tables (``sl_nodes6``,
``sl_meta6``) exactly as the JAX package does without importing it.

A skip-pointer DFS fixes the child visit order at build time, so a single
layout cannot traverse near-to-far for every ray. The classic stackless fix
is SIX pretabulated layouts — one per dominant direction axis and sign —
each flattening the SAME tree with children ordered by their bbox center
along that axis (near child first). A ray packet picks the layout matching
its dominant direction, so best-t pruning fires as early as possible.

Superleaf trees are tiny (~2*n_tris/512 nodes), so rebuilding 6 layouts in
Python from the builder's single flattened form is negligible.
"""
from __future__ import annotations

import numpy as np


def _children(skip: np.ndarray, prim_count: np.ndarray, i: int):
    """(left, right) of internal node i in the flattened DFS form: the left
    child is i+1; the right child is the left subtree's escape, skip[i+1]."""
    left = i + 1
    right = int(skip[left])
    return left, right


def build_directional_layouts(node_min: np.ndarray, node_max: np.ndarray,
                              prim_count: np.ndarray, skip: np.ndarray,
                              leaf_value: np.ndarray, pad: bool = True):
    """Returns (bounds6 [6,8,Npad] f32, meta6 [6,2,Npad] i32).

    leaf_value: per-node int (0 = internal, else payload, e.g. block_id+1)
    carried into each layout's meta. Layout index = axis*2 + (1 if the ray
    direction along `axis` is negative else 0). ``pad=False`` returns the
    exact-N form (for forest concatenation).
    """
    n = int(skip.shape[0])
    center = (node_min + node_max) * 0.5
    n_pad = ((n + 127) // 128) * 128 if pad else n

    bounds6 = np.zeros((6, 8, n_pad), np.float32)
    meta6 = np.zeros((6, 2, n_pad), np.int32)

    # Subtree sizes are order-invariant; compute once bottom-up over the
    # original DFS layout (children always come after their parent).
    sizes = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        if prim_count[i] == 0:
            l, r = _children(skip, prim_count, i)
            sizes[i] = 1 + sizes[l] + sizes[r]

    for axis in range(3):
        for neg in (0, 1):
            li = axis * 2 + neg
            # Iterative preorder with the near child (by bbox center along
            # `axis`, respecting sign) pushed last so it pops first.
            order = []
            stack = [0]
            while stack:
                i = stack.pop()
                order.append(i)
                if prim_count[i] > 0:
                    continue
                l, r = _children(skip, prim_count, i)
                if neg == 0:
                    near, far = (l, r) if center[l, axis] <= center[r, axis] \
                        else (r, l)
                else:
                    near, far = (l, r) if center[l, axis] >= center[r, axis] \
                        else (r, l)
                stack.append(far)   # popped second
                stack.append(near)  # popped first -> preorder next
            for pos, old in enumerate(order):
                bounds6[li, 0:3, pos] = node_min[old]
                bounds6[li, 3:6, pos] = node_max[old]
                meta6[li, 0, pos] = pos + sizes[old]  # escape index
                meta6[li, 1, pos] = leaf_value[old]

    return bounds6, meta6


def build_directional_layouts_forest(trees):
    """Directional layouts of a multi-root skip-pointer FOREST.

    trees: list of (node_min, node_max, prim_count, skip, leaf_value)
    tuples, one per independent tree. Each tree's six layouts are built
    standalone and concatenated along the node axis; escape indices of tree
    j are offset by the total node count before it, so a walk exits tree j
    straight into tree j+1's root and terminates at the summed real node
    count (the same invariant the single-tree form has). Used by the
    opacity partition: tree 0 = opaque blocks, tree 1 = transparent blocks.
    """
    parts = [build_directional_layouts(*t, pad=False) for t in trees]
    sizes = [p[0].shape[2] for p in parts]
    total = sum(sizes)
    n_pad = ((total + 127) // 128) * 128
    bounds6 = np.zeros((6, 8, n_pad), np.float32)
    meta6 = np.zeros((6, 2, n_pad), np.int32)
    off = 0
    for (b6, m6), n in zip(parts, sizes):
        bounds6[:, :, off : off + n] = b6
        meta6[:, 1, off : off + n] = m6[:, 1]
        meta6[:, 0, off : off + n] = m6[:, 0] + off  # escape indices global
        off += n
    return bounds6, meta6
