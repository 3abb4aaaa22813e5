"""SceneTree: a tree of per-directory COLMAP scenes.

Port of gtsfm_tpu/products/scene_tree.py: one node per reconstruction
directory (COLMAP text), children mirroring the cluster hierarchy
(``results/C_1/C_1_2/...``); read, write, and walks over the tree. The
scene optimizer writes a hierarchical run's cluster results through it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

from gtsfm_tpu_torch.common.sfm_data import SfmData
from gtsfm_tpu_torch.io import colmap as colmap_io


@dataclasses.dataclass
class SceneTree:
    """A reconstruction directory, its scene and its child directories."""

    directory: str
    scene: Optional[SfmData] = None
    children: List["SceneTree"] = dataclasses.field(default_factory=list)

    @classmethod
    def read(cls, root: str, load_scenes: bool = True) -> "SceneTree":
        """Read a results tree: a directory with cameras.txt holds a scene;
        subdirectories with a scene below them become children."""
        node = cls(directory=root)
        if load_scenes and os.path.exists(os.path.join(root, "cameras.txt")):
            node.scene = colmap_io.read_scene(root)
        for name in sorted(os.listdir(root)):
            sub = os.path.join(root, name)
            if os.path.isdir(sub) and _contains_scene(sub):
                node.children.append(cls.read(sub, load_scenes=load_scenes))
        return node

    def write(self) -> None:
        if self.scene is not None:
            colmap_io.write_scene(self.scene, self.directory)
        for c in self.children:
            c.write()

    def all_scenes(self) -> list:
        out = [self.scene] if self.scene is not None else []
        for c in self.children:
            out.extend(c.all_scenes())
        return out

    def map_postorder(self, fn):
        child_results = [c.map_postorder(fn) for c in self.children]
        return fn(self, child_results)

    def num_nodes(self) -> int:
        return (1 if self.scene is not None else 0) + sum(c.num_nodes() for c in self.children)


def _contains_scene(path: str) -> bool:
    for _dirpath, _dirs, files in os.walk(path):
        if "cameras.txt" in files:
            return True
    return False
