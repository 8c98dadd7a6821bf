"""ECS-lite World: entities as component dicts + typed resources + schedules.

The TPU-native replacement for the reference's ``bevy_ecs::World`` usage
(mo_core/src/application/mod.rs:24, :89-126).  The reference only ever uses
plain component queries (``world.query::<(&Transform, &mut Model)>``) and
typed resources — a dict-of-dicts world covers that API surface without a
dependency.  Scene data is packed separately into static-shape device arrays
(scene/scene_buffers.py); the World itself is host-side and dynamic.
"""

from __future__ import annotations

from typing import Any, Iterator


class Entity:
    """Lightweight entity handle (an id + back-reference)."""

    __slots__ = ("id", "_world")

    def __init__(self, eid: int, world: "World"):
        self.id = eid
        self._world = world

    def get(self, component_type: type):
        return self._world.entity_components(self.id).get(component_type)

    def insert(self, component):
        self._world.entity_components(self.id)[type(component)] = component
        return self

    def __repr__(self):
        return f"Entity({self.id})"


class World:
    """Entity/component/resource store."""

    def __init__(self):
        self._entities: dict[int, dict[type, Any]] = {}
        self._resources: dict[type, Any] = {}
        self._next_id = 0
        # bumped on every topology change (spawn/despawn) so renderers can
        # detect a stale packed scene — the analog of the reference
        # re-querying the world every frame (gbuffer_pass.rs:516-548)
        self.generation = 0

    # --- entities (App::add_entity, mod.rs:120-126) ---------------------
    def spawn(self, components=()) -> Entity:
        eid = self._next_id
        self._next_id += 1
        self._entities[eid] = {type(c): c for c in components}
        self.generation += 1
        return Entity(eid, self)

    def despawn(self, entity) -> None:
        eid = entity.id if isinstance(entity, Entity) else entity
        if self._entities.pop(eid, None) is not None:
            self.generation += 1

    def entity_components(self, eid: int) -> dict[type, Any]:
        return self._entities[eid]

    def component_dicts(self):
        """Every entity's {type: component} dict, in spawn order: a live
        view for reading, the order ``query`` visits them in."""
        return self._entities.values()

    def iter_entities(self) -> Iterator[Entity]:
        for eid in list(self._entities):
            yield Entity(eid, self)

    # --- queries --------------------------------------------------------
    def query(self, *component_types: type) -> Iterator[tuple]:
        """Yield component tuples for every entity holding all given types.

        Single-type queries yield the bare component (not a 1-tuple), which
        matches how the reference uses ``query::<&DirectionalLight>``.
        """
        for comps in self._entities.values():
            if all(t in comps for t in component_types):
                row = tuple(comps[t] for t in component_types)
                yield row[0] if len(row) == 1 else row

    def query_entities(self, *component_types: type) -> Iterator[tuple]:
        """Like query() but yields (Entity, components...)."""
        for eid, comps in list(self._entities.items()):
            if all(t in comps for t in component_types):
                yield (Entity(eid, self), *(comps[t] for t in component_types))

    # --- resources (mod.rs:89-97) ---------------------------------------
    def init_resource(self, resource_type: type):
        if resource_type not in self._resources:
            self._resources[resource_type] = resource_type()
        return self._resources[resource_type]

    def insert_resource(self, resource) -> None:
        self._resources[type(resource)] = resource

    def resource(self, resource_type: type):
        return self._resources[resource_type]

    def get_resource(self, resource_type: type):
        return self._resources.get(resource_type)

    def contains_resource(self, resource_type: type) -> bool:
        return resource_type in self._resources


class Schedule:
    """Ordered list of systems: callables taking (World)."""

    def __init__(self):
        self._systems: list = []

    def add_system(self, system) -> None:
        self._systems.append(system)

    def run(self, world: World) -> None:
        for system in self._systems:
            system(world)

    def __len__(self):
        return len(self._systems)
