"""Zhang-Shasha tree edit distance — offline stand-in for the `zss` pip
package, exposing exactly the surface the reference's synthdog evaluator
uses (evaluate/lmms_eval/tasks/synthdog/donut_evaluator.py:16-21,195-225:
`Node(label)`, `node.addkid`, `Node.get_children`, and
`zss.distance(A, B, get_children, insert_cost, remove_cost, update_cost)`).

Implemented from the algorithm (K. Zhang & D. Shasha, "Simple fast
algorithms for the editing distance between trees", SIAM J. Comput. 1989):
post-order numbering, leftmost-leaf-descendant table, keyroot set, and the
forest-distance dynamic program with caller-supplied per-node costs.

The port's own copy of competesmoe_tpu/eval/zss_compat.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

from typing import Callable, List


class Node:
    """zss-compatible tree node."""

    def __init__(self, label, children=None):
        self.label = label
        self.children: List["Node"] = list(children or [])

    def addkid(self, node, before: bool = False) -> "Node":
        if before:
            self.children.insert(0, node)
        else:
            self.children.append(node)
        return self

    @staticmethod
    def get_children(node) -> List["Node"]:
        return node.children

    @staticmethod
    def get_label(node):
        return node.label


def _annotate(root, get_children: Callable):
    """Post-order node list + leftmost-leaf-descendant indices + keyroots.

    A keyroot is a node with no later node sharing its leftmost leaf
    (equivalently: the root and every node with a left sibling)."""
    nodes: List = []
    lmds: List[int] = []
    stack = [(root, False)]
    lmd_stack: List[List[int]] = [[]]
    while stack:
        node, visited = stack.pop()
        children = get_children(node)
        if visited or not children:
            kid_lmds = lmd_stack.pop() if children else []
            idx = len(nodes)
            nodes.append(node)
            lmds.append(kid_lmds[0] if kid_lmds else idx)
            lmd_stack[-1].append(lmds[idx])
        else:
            stack.append((node, True))
            lmd_stack.append([])
            for c in reversed(children):
                stack.append((c, False))
    last_for_lmd = {}
    for i, l in enumerate(lmds):
        last_for_lmd[l] = i
    keyroots = sorted(last_for_lmd.values())
    return nodes, lmds, keyroots


def distance(A, B, get_children: Callable = Node.get_children,
             insert_cost: Callable = lambda n: 1,
             remove_cost: Callable = lambda n: 1,
             update_cost: Callable = lambda a, b: int(a.label != b.label),
             return_operations: bool = False) -> float:
    """Exact tree edit distance between rooted ordered trees A and B."""
    an, al, akr = _annotate(A, get_children)
    bn, bl, bkr = _annotate(B, get_children)
    n1, n2 = len(an), len(bn)
    td = [[0.0] * n2 for _ in range(n1)]

    for i in akr:
        for j in bkr:
            li, lj = al[i], bl[j]
            m = i - li + 2
            n = j - lj + 2
            fd = [[0.0] * n for _ in range(m)]
            for x in range(1, m):
                fd[x][0] = fd[x - 1][0] + remove_cost(an[li + x - 1])
            for y in range(1, n):
                fd[0][y] = fd[0][y - 1] + insert_cost(bn[lj + y - 1])
            for x in range(1, m):
                ni = li + x - 1
                for y in range(1, n):
                    nj = lj + y - 1
                    if al[ni] == li and bl[nj] == lj:
                        fd[x][y] = min(
                            fd[x - 1][y] + remove_cost(an[ni]),
                            fd[x][y - 1] + insert_cost(bn[nj]),
                            fd[x - 1][y - 1] + update_cost(an[ni], bn[nj]))
                        td[ni][nj] = fd[x][y]
                    else:
                        p = al[ni] - li
                        q = bl[nj] - lj
                        fd[x][y] = min(
                            fd[x - 1][y] + remove_cost(an[ni]),
                            fd[x][y - 1] + insert_cost(bn[nj]),
                            fd[p][q] + td[ni][nj])
    result = td[n1 - 1][n2 - 1]
    if return_operations:
        return result, []
    return result


def simple_distance(A, B, get_children: Callable = Node.get_children,
                    get_label: Callable = Node.get_label,
                    label_dist: Callable = lambda a, b: int(a != b)):
    return distance(
        A, B, get_children,
        insert_cost=lambda n: 1, remove_cost=lambda n: 1,
        update_cost=lambda a, b: label_dist(get_label(a), get_label(b)))
