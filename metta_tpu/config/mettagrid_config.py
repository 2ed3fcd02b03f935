"""MettaGrid configuration tree (pydantic v2).

Parity: reference ``mettagrid/config/mettagrid_config.py:1-613``. The public
surface (class/field names, defaults, semantics) matches the reference so
recipes translate directly; the implementation is original.

The config is compiled into dense device arrays by
``metta_tpu.engine.compiler`` — the array-native replacement for the reference's
``convert_to_cpp_game_config`` (``config/mettagrid_c_config.py``).
"""

from __future__ import annotations

from typing import Annotated, Any, Literal, Optional, Union, get_args

from pydantic import field_validator, ConfigDict, Discriminator, Field, SerializeAsAny, Tag, model_validator

from metta_tpu.config.base import Config
from metta_tpu.config.obs_config import ObsConfig
from metta_tpu.config.vibes import VIBES, Vibe

Direction = Literal[
    "north", "south", "east", "west", "northeast", "northwest", "southeast", "southwest"
]
Directions = list(get_args(Direction))

# Order matters: the engine's direction-id table matches the reference's
# Orientation enum (actions/orientation.hpp:7-16): N, S, W, E, NW, NE, SW, SE.
CardinalDirection = Literal["north", "south", "west", "east"]
CardinalDirections = list(get_args(CardinalDirection))

# (dr, dc) per orientation id, matching orientation.hpp:33-52.
ORIENTATION_NAMES: list[str] = [
    "north", "south", "west", "east", "northwest", "northeast", "southwest", "southeast"
]
ORIENTATION_DELTAS: list[tuple[int, int]] = [
    (-1, 0),  # north
    (1, 0),   # south
    (0, -1),  # west
    (0, 1),   # east
    (-1, -1),  # northwest
    (-1, 1),   # northeast
    (1, -1),   # southwest
    (1, 1),    # southeast
]


class AgentRewards(Config):
    """Agent reward configuration (inventory rewards merge into stat rewards).

    Parity: ``mettagrid_config.py:36-45``. ``inventory`` keys are resource
    names; at compile time they become ``<resource>.amount`` stat rewards.
    """

    inventory: dict[str, float] = Field(default_factory=dict)
    inventory_max: dict[str, float] = Field(default_factory=dict)
    stats: dict[str, float] = Field(default_factory=dict)
    stats_max: dict[str, float] = Field(default_factory=dict)


class ResourceLimitsConfig(Config):
    """A shared inventory limit over a group of resources with modifiers.

    Parity: ``mettagrid_config.py:48-69`` / ``inventory_config.hpp``.
    Effective limit = limit + sum(modifier_bonus * held modifier items).
    """

    limit: int
    resources: list[str]
    modifiers: dict[str, int] = Field(default_factory=dict)


class InventoryConfig(Config):
    """Inventory configuration for agents / chests / collectives."""

    default_limit: int = Field(default=65535, ge=0)
    limits: dict[str, ResourceLimitsConfig] = Field(default_factory=dict)
    initial: dict[str, int] = Field(default_factory=dict)
    regen_amounts: dict[str, dict[str, int]] = Field(
        default_factory=dict,
        description="Vibe-name -> {resource: amount} regeneration; 'default' is the fallback.",
    )

    def get_limit(self, resource_name: str) -> int:
        for lim in self.limits.values():
            if resource_name in lim.resources:
                return lim.limit
        return self.default_limit


class DamageConfig(Config):
    """Threshold-triggered weighted-random resource destruction.

    Parity: ``agent_config.hpp DamageConfig`` + ``agent.cpp:137-183``.
    """

    threshold: dict[str, int] = Field(default_factory=dict)
    resources: dict[str, int] = Field(default_factory=dict)

    @model_validator(mode="after")
    def _distinct_keys(self) -> "DamageConfig":
        overlap = set(self.threshold) & set(self.resources)
        if overlap:
            raise ValueError(f"Resources cannot be in both threshold and resources: {sorted(overlap)}")
        return self


class AgentConfig(Config):
    """Per-agent (or per-team-template) configuration."""

    inventory: InventoryConfig = Field(default_factory=InventoryConfig)
    rewards: AgentRewards = Field(default_factory=AgentRewards)
    freeze_duration: int = Field(default=10, ge=-1)
    team_id: int = Field(default=0, ge=0)
    tags: list[str] = Field(default_factory=lambda: ["agent"])
    diversity_tracked_resources: list[str] = Field(default_factory=list)
    initial_vibe: int = Field(default=0, ge=0)
    damage: Optional[DamageConfig] = Field(default=None)


class ActionConfig(Config):
    """Base action configuration."""

    action_handler: str
    enabled: bool = Field(default=True)
    required_resources: dict[str, int] = Field(default_factory=dict)
    consumed_resources: dict[str, int] = Field(default_factory=dict)


class NoopActionConfig(ActionConfig):
    action_handler: str = Field(default="noop")


class MoveActionConfig(ActionConfig):
    action_handler: str = Field(default="move")
    allowed_directions: list[Direction] = Field(default_factory=lambda: list(CardinalDirections))


class ChangeVibeActionConfig(ActionConfig):
    action_handler: str = Field(default="change_vibe")
    vibes: list[Vibe] = Field(default_factory=lambda: list(VIBES))


class AttackOutcome(Config):
    """Outcome applied when an attack succeeds (attack.hpp:22-34)."""

    actor_inv_delta: dict[str, int] = Field(default_factory=dict)
    target_inv_delta: dict[str, int] = Field(default_factory=dict)
    loot: list[str] = Field(default_factory=list)
    freeze: int = Field(default=0)


class AttackActionConfig(ActionConfig):
    """Attack: triggered by moving onto an agent while showing a matching vibe.

    Defense: weapon_power = Σ attacker_inv*weapon_w; armor_power =
    Σ (target_inv + vibe_bonus if vibing that resource)*armor_w; target blocks
    iff it can pay defense_resources + max(weapon-armor, 0) for every defense
    item (attack.hpp:143-198).
    """

    action_handler: str = Field(default="attack")
    defense_resources: dict[str, int] = Field(default_factory=dict)
    armor_resources: dict[str, int] = Field(default_factory=dict)
    weapon_resources: dict[str, int] = Field(default_factory=dict)
    success: AttackOutcome = Field(default_factory=AttackOutcome)
    vibes: list[str] = Field(default_factory=list)
    vibe_bonus: dict[str, int] = Field(default_factory=dict)


class VibeTransfer(Config):
    """Resource exchange triggered by moving onto an agent with this vibe."""

    vibe: str
    target: dict[str, int] = Field(default_factory=dict)
    actor: dict[str, int] = Field(default_factory=dict)


class TransferActionConfig(ActionConfig):
    action_handler: str = Field(default="transfer")
    vibe_transfers: list[VibeTransfer] = Field(default_factory=list)


class ActionsConfig(Config):
    """Actions configuration; omitted actions are disabled by default."""

    noop: NoopActionConfig = Field(default_factory=NoopActionConfig)
    move: MoveActionConfig = Field(default_factory=MoveActionConfig)
    attack: AttackActionConfig = Field(default_factory=lambda: AttackActionConfig(enabled=False))
    transfer: TransferActionConfig = Field(default_factory=lambda: TransferActionConfig(enabled=False))
    change_vibe: ChangeVibeActionConfig = Field(default_factory=ChangeVibeActionConfig)

    def action_names(self) -> list[str]:
        """Flattened discrete action-variant names, in engine order.

        Parity with the reference's flattened ``Action`` list
        (``mettagrid_c.cpp:291-352``): noop, move_<dir>..., change_vibe_<vibe>...
        (attack/transfer contribute no standalone actions).
        """
        names: list[str] = []
        if self.noop.enabled:
            names.append("noop")
        if self.move.enabled:
            names.extend(f"move_{d}" for d in self.move.allowed_directions)
        if self.change_vibe.enabled:
            names.extend(f"change_vibe_{v.name}" for v in self.change_vibe.vibes)
        return names


class GlobalObsConfig(Config):
    """Global observation token toggles (mettagrid_c.cpp:433-517)."""

    episode_completion_pct: bool = Field(default=True)
    last_action: bool = Field(default=True)
    last_reward: bool = Field(default=True)
    compass: bool = Field(default=False)
    goal_obs: bool = Field(default=False)


class GridObjectConfig(Config):
    """Base configuration for all grid objects."""

    name: str = Field(description="Canonical type_name")
    map_name: str = Field(default="", description="Key used by maps to select this config")
    render_name: str = Field(default="")
    render_symbol: str = Field(default="❓")
    tags: list[str] = Field(default_factory=list)
    vibe: int = Field(default=0, ge=0, le=255)
    collective: Optional[str] = Field(default=None)

    @model_validator(mode="after")
    def _defaults_from_name(self) -> "GridObjectConfig":
        if not self.map_name:
            self.map_name = self.name
        if not self.render_name:
            self.render_name = self.name
        if not self.tags:
            self.tags = [self.render_name]
        if self.collective:
            tag = f"collective:{self.collective}"
            if tag not in self.tags:
                self.tags = self.tags + [tag]
        return self


class WallConfig(GridObjectConfig):
    pydantic_type: Literal["wall"] = "wall"
    name: str = Field(default="wall")


class ProtocolConfig(Config):
    """A crafting protocol (protocol.hpp). ``vibes`` implicitly sets a minimum
    participant count; ``min_agents`` raises it further."""

    min_agents: int = Field(default=0, ge=0)
    vibes: list[str] = Field(default_factory=list)
    input_resources: dict[str, int] = Field(default_factory=dict)
    output_resources: dict[str, int] = Field(default_factory=dict)
    cooldown: int = Field(ge=0, default=0)


class AssemblerConfig(GridObjectConfig):
    pydantic_type: Literal["assembler"] = "assembler"
    protocols: list[ProtocolConfig] = Field(
        default_factory=list, description="Protocols in reverse order of priority."
    )
    allow_partial_usage: bool = Field(default=False)
    max_uses: int = Field(default=0, ge=0)
    clip_immune: bool = Field(default=False)
    start_clipped: bool = Field(default=False)
    chest_search_distance: int = Field(default=0, ge=0)


class ChestConfig(GridObjectConfig):
    pydantic_type: Literal["chest"] = "chest"
    name: str = Field(default="chest")
    vibe_transfers: dict[str, dict[str, int]] = Field(default_factory=dict)
    inventory: InventoryConfig = Field(default_factory=InventoryConfig)


class ClipperConfig(Config):
    """Global clipper infection process over assemblers (clipper.hpp:14-238)."""

    unclipping_protocols: list[ProtocolConfig] = Field(default_factory=list)
    length_scale: int = Field(default=0, ge=0)
    scaled_cutoff_distance: int = Field(default=3, ge=1)
    clip_period: int = Field(default=0, ge=0)


class CollectiveConfig(Config):
    """A named shared inventory; objects join via 'collective:<name>' tags."""

    name: str
    inventory: InventoryConfig = Field(default_factory=InventoryConfig)


class AOESourceConfig(Config):
    """Binds an AOE effect to every map instance of a static object type.

    Parity: ``core/aoe_config.hpp`` + ``core/aoe_helper.hpp`` (the reference
    exposes AOEConfig through bindings but leaves trigger plumbing to the
    embedding; here every placed instance of ``object`` is a registered
    source, applied to agents each step). ``aoe.target_tag_ids`` use the
    sorted-tag id order (the IdMap contract); ``target_tags`` accepts names
    and is merged in by the compiler.
    """

    model_config = ConfigDict(arbitrary_types_allowed=True, extra="forbid")

    object: str  # object type name (key of GameConfig.objects)
    aoe: Any = None  # engine.activation.AOEConfig (deferred import; dicts coerced)
    target_tags: list[str] = Field(default_factory=list)

    @model_validator(mode="after")
    def _coerce_aoe(self) -> "AOESourceConfig":
        from metta_tpu.engine.activation import AOEConfig as _AOE

        if self.aoe is None:
            self.aoe = _AOE()
        elif isinstance(self.aoe, dict):
            self.aoe = _AOE(**self.aoe)
        elif not isinstance(self.aoe, _AOE):
            raise TypeError(f"aoe must be an AOEConfig, got {type(self.aoe)}")
        return self


AnyGridObjectConfig = SerializeAsAny[
    Annotated[
        Union[
            Annotated[WallConfig, Tag("wall")],
            Annotated[AssemblerConfig, Tag("assembler")],
            Annotated[ChestConfig, Tag("chest")],
        ],
        Discriminator("pydantic_type"),
    ]
]

DEFAULT_RESOURCE_NAMES = [
    "ore_red", "ore_blue", "ore_green",
    "battery_red", "battery_blue", "battery_green",
    "heart", "armor", "laser", "blueprint",
]


class GameConfig(Config):
    """Game configuration. Parity: ``mettagrid_config.py:443-596``."""

    model_config = ConfigDict(arbitrary_types_allowed=True, extra="forbid")

    resource_names: list[str] = Field(default_factory=lambda: list(DEFAULT_RESOURCE_NAMES))
    vibe_names: list[str] = Field(default_factory=list)
    num_agents: int = Field(ge=1, default=24)
    max_steps: int = Field(ge=0, default=10000)
    episode_truncates: bool = Field(default=False)
    obs: ObsConfig = Field(default_factory=ObsConfig)
    agent: AgentConfig = Field(default_factory=AgentConfig)
    agents: list[AgentConfig] = Field(default_factory=list)
    actions: ActionsConfig = Field(default_factory=ActionsConfig)
    global_obs: GlobalObsConfig = Field(default_factory=GlobalObsConfig)
    objects: dict[str, AnyGridObjectConfig] = Field(default_factory=dict)
    params: Optional[Any] = None
    inventory_regen_interval: int = Field(default=0, ge=0)
    clipper: Optional[ClipperConfig] = Field(default=None)
    collectives: list[CollectiveConfig] = Field(default_factory=list)
    # AOE sources + config-driven bump interactions (the reference binds
    # these config types via activation_handler_bindings.hpp/aoe_bindings.hpp;
    # here they are first-class engine features — see engine/activation_wiring.py)
    aoe_sources: list[AOESourceConfig] = Field(default_factory=list)
    on_bump_handlers: list[Any] = Field(default_factory=list)

    @field_validator("on_bump_handlers", mode="after")
    @classmethod
    def _coerce_handlers(cls, v):
        from metta_tpu.engine.activation import ActivationHandlerConfig

        out = []
        for h in v:
            if isinstance(h, dict):
                h = ActivationHandlerConfig(**h)
            elif not isinstance(h, ActivationHandlerConfig):
                raise TypeError(f"on_bump_handlers entries must be "
                                f"ActivationHandlerConfig, got {type(h)}")
            out.append(h)
        return out
    map_builder: Any = Field(default=None)

    @field_validator("map_builder", mode="before")
    @classmethod
    def _resolve_map_builder(cls, v):
        from metta_tpu.map_builder.map_builder import load_map_builder_config

        return load_map_builder_config(v)
    protocol_details_obs: bool = Field(default=True)
    reward_estimates: Optional[dict[str, float]] = None

    @model_validator(mode="after")
    def _sync_vibe_names(self) -> "GameConfig":
        self.vibe_names = [v.name for v in self.actions.change_vibe.vibes]
        if self.map_builder is None:
            from metta_tpu.map_builder.random_map import RandomMapBuilder

            self.map_builder = RandomMapBuilder.Config(agents=self.num_agents)
        return self

    def id_map(self):
        from metta_tpu.config.id_map import IdMap

        return IdMap(self)


class MettaGridConfig(Config):
    """Top-level environment configuration."""

    label: str = Field(default="mettagrid")
    game: GameConfig = Field(default_factory=GameConfig)
    desync_episodes: bool = Field(default=True)

    def with_ascii_map(
        self, map_data: list[list[str]], char_to_map_name: dict[str, str]
    ) -> "MettaGridConfig":
        from metta_tpu.map_builder.ascii import AsciiMapBuilder

        self.game.map_builder = AsciiMapBuilder.Config(
            map_data=map_data, char_to_map_name=char_to_map_name
        )
        return self

    @staticmethod
    def EmptyRoom(
        num_agents: int,
        width: int = 10,
        height: int = 10,
        border_width: int = 1,
        with_walls: bool = False,
    ) -> "MettaGridConfig":
        from metta_tpu.map_builder.random_map import RandomMapBuilder

        map_builder = RandomMapBuilder.Config(
            agents=num_agents, width=width, height=height, border_width=border_width
        )
        actions = ActionsConfig(move=MoveActionConfig(), change_vibe=ChangeVibeActionConfig())
        objects: dict[str, Any] = {}
        if border_width > 0 or with_walls:
            objects["wall"] = WallConfig(render_symbol="⬛")
        return MettaGridConfig(
            game=GameConfig(
                map_builder=map_builder, actions=actions, num_agents=num_agents, objects=objects
            )
        )
