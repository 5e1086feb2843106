"""Relational schema following the paper's E/R conventions (§4).

* Entity tables: integer dense primary key ``ID`` in [0, h), optional attribute
  columns (measures or FKs capturing many-to-one relationships, e.g. Doc.Journal).
* Relationship tables: exactly two FK columns referencing entity IDs plus any
  number of measure columns.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class EntityTable:
    name: str
    size: int  # domain size h; IDs are the dense range [0, h)
    attributes: dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        for a, col in self.attributes.items():
            assert col.shape[0] == self.size, (self.name, a, col.shape, self.size)


@dataclass
class RelationshipTable:
    name: str
    fk1: str  # attribute name of the first foreign key
    fk2: str
    entity1: str  # referenced entity table names
    entity2: str
    columns: dict[str, np.ndarray] = field(default_factory=dict)  # fk + measure cols

    @property
    def measures(self) -> list[str]:
        return [c for c in self.columns if c not in (self.fk1, self.fk2)]

    @property
    def num_rows(self) -> int:
        return int(self.columns[self.fk1].shape[0])

    def fk_entity(self, fk: str) -> str:
        return self.entity1 if fk == self.fk1 else self.entity2

    def other_fk(self, fk: str) -> str:
        return self.fk2 if fk == self.fk1 else self.fk1


@dataclass
class Schema:
    entities: dict[str, EntityTable]
    relationships: dict[str, RelationshipTable]

    def entity_of(self, table: str, attr: str) -> str:
        """Entity domain an attribute draws its values from (for key attrs)."""
        if table in self.entities:
            return table  # ID attr of an entity table
        rel = self.relationships[table]
        if attr == rel.fk1:
            return rel.entity1
        if attr == rel.fk2:
            return rel.entity2
        raise KeyError(f"{table}.{attr} is not a key attribute")

    def domain_size(self, entity: str) -> int:
        return self.entities[entity].size

    def is_relationship(self, table: str) -> bool:
        return table in self.relationships

    def validate(self) -> None:
        for r in self.relationships.values():
            assert r.entity1 in self.entities and r.entity2 in self.entities
            n = r.num_rows
            for c, col in r.columns.items():
                assert col.shape[0] == n, (r.name, c)
            for fk, ent in ((r.fk1, r.entity1), (r.fk2, r.entity2)):
                col = r.columns[fk]
                assert col.min(initial=0) >= 0
                assert col.max(initial=0) < self.entities[ent].size, (r.name, fk)
