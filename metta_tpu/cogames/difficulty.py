"""Difficulty variants for CoGames missions.

Ported config/content table: the knob names,
numeric values, and clipping gear mapping ARE the compatibility contract.
Parity: reference ``cogames/cogs_vs_clips/evals/difficulty_variants.py``.

Each difficulty level modifies extractor depletion (max_uses), resource
output (efficiency), passive energy regen, and optionally starts a target
extractor clipped with a single-gear unclip path.
"""

from __future__ import annotations

from typing import Optional

from pydantic import Field

from metta_tpu.config.mettagrid_config import (
    AssemblerConfig,
    MettaGridConfig,
    ProtocolConfig,
)
from metta_tpu.cogames.mission import Mission, MissionVariant

RESOURCE_KEYS = ("carbon", "oxygen", "germanium", "silicon")

ENERGY_REGEN_FLOOR = 0

#: clip target -> (required unclip gear, resource that crafts it)
#: (difficulty_variants.py:221-226)
GEAR_BY_TARGET: dict[str, tuple[str, str]] = {
    "carbon": ("modulator", "oxygen"),
    "oxygen": ("decoder", "carbon"),
    "germanium": ("resonator", "silicon"),
    "silicon": ("scrambler", "germanium"),
}


class DifficultyLevel(MissionVariant):
    """Configuration for a difficulty level (difficulty_variants.py:44-91)."""

    name: str
    description: str = ""
    allow_agent_scaling: bool = Field(default=True)

    carbon_max_uses_mult: float = 1.0
    oxygen_max_uses_mult: float = 1.0
    germanium_max_uses_mult: float = 1.0
    silicon_max_uses_mult: float = 1.0

    carbon_eff_mult: float = 1.0
    oxygen_eff_mult: float = 1.0
    germanium_eff_mult: float = 1.0
    silicon_eff_mult: float = 1.0
    charger_eff_mult: float = 1.0

    energy_regen_mult: float = 1.0

    carbon_max_uses_override: Optional[int] = None
    oxygen_max_uses_override: Optional[int] = None
    germanium_max_uses_override: Optional[int] = None
    silicon_max_uses_override: Optional[int] = None

    carbon_eff_override: Optional[int] = None
    oxygen_eff_override: Optional[int] = None
    germanium_eff_override: Optional[int] = None
    silicon_eff_override: Optional[int] = None
    charger_eff_override: Optional[int] = None

    energy_regen_override: Optional[int] = None
    move_energy_cost_override: Optional[int] = None
    energy_capacity_override: Optional[int] = None
    cargo_capacity_override: Optional[int] = None
    max_steps_override: Optional[int] = None

    clip_period: int = Field(default=0)
    clip_target: Optional[str] = None
    clip_immune_extractor: Optional[str] = None

    def modify_mission(self, mission: Mission) -> None:
        # max_uses: override wins, else multiply with a floor of 1 when the
        # baseline was > 0 (germanium has no max_uses knob — hardcoded 1)
        for res in RESOURCE_KEYS:
            extractor = getattr(mission, f"{res}_extractor")
            if not hasattr(extractor, "max_uses"):
                continue
            override_val = getattr(self, f"{res}_max_uses_override")
            if override_val is not None:
                extractor.max_uses = override_val
            else:
                mu = int(extractor.max_uses)
                scaled = int(mu * getattr(self, f"{res}_max_uses_mult"))
                extractor.max_uses = max(1, scaled) if mu > 0 else scaled

        for res in RESOURCE_KEYS:
            extractor = getattr(mission, f"{res}_extractor")
            override_val = getattr(self, f"{res}_eff_override")
            if override_val is not None:
                extractor.efficiency = override_val
            else:
                extractor.efficiency = int(
                    int(extractor.efficiency) * getattr(self, f"{res}_eff_mult")
                )

        if self.charger_eff_override is not None:
            mission.charger.efficiency = self.charger_eff_override
        else:
            mission.charger.efficiency = int(
                mission.charger.efficiency * self.charger_eff_mult
            )

        if self.energy_regen_override is not None:
            mission.energy_regen_amount = self.energy_regen_override
        else:
            mission.energy_regen_amount = max(
                0, int(mission.energy_regen_amount * self.energy_regen_mult)
            )

        if self.move_energy_cost_override is not None:
            mission.move_energy_cost = self.move_energy_cost_override
        if self.energy_capacity_override is not None:
            mission.energy_capacity = self.energy_capacity_override
        if self.cargo_capacity_override is not None:
            mission.cargo_capacity = self.cargo_capacity_override
        if self.clip_period > 0:
            mission.clip_period = self.clip_period

        target = self.clip_target
        if target in RESOURCE_KEYS:
            getattr(mission, f"{target}_extractor").start_clipped = True
        elif target == "charger":
            mission.charger.start_clipped = True

    def modify_env(self, mission: Mission, env: MettaGridConfig) -> None:
        if self.max_steps_override is not None:
            env.game.max_steps = self.max_steps_override

        self._apply_clipping(env)

        if not self.allow_agent_scaling:
            return

        # agent-aware scaling: extractor budgets grow with the cog count
        num_agents = env.game.num_agents
        for res in RESOURCE_KEYS:
            obj = env.game.objects.get(f"{res}_extractor")
            if not isinstance(obj, AssemblerConfig):
                continue
            if obj.max_uses > 0 and num_agents > 1:
                obj.max_uses = obj.max_uses * num_agents

        default_regen = env.game.agent.inventory.regen_amounts.get("default", {})
        current_regen = default_regen.get("energy", 1)
        if current_regen > 0:
            env.game.agent.inventory.regen_amounts.setdefault("default", {})
            env.game.agent.inventory.regen_amounts["default"]["energy"] = max(
                ENERGY_REGEN_FLOOR, current_regen
            )

    def _apply_clipping(self, cfg: MettaGridConfig) -> None:
        target = self.clip_target
        if target not in GEAR_BY_TARGET:
            return
        required_gear, resource_for_gear = GEAR_BY_TARGET[target]

        # only the required gear unclips in this variant
        if cfg.game.clipper is not None:
            cfg.game.clipper.unclipping_protocols = [
                r for r in cfg.game.clipper.unclipping_protocols
                if r.input_resources == {required_gear: 1}
            ]

        # one generic ["gear"] protocol crafts the required gear (the engine
        # allows one protocol per unique vibe list)
        asm = cfg.game.objects.get("assembler")
        if isinstance(asm, AssemblerConfig) and not any(
            p.vibes == ["gear"] for p in asm.protocols
        ):
            asm.protocols.append(ProtocolConfig(
                vibes=["gear"],
                input_resources={resource_for_gear: 1},
                output_resources={required_gear: 1},
            ))

        # the gear-resource extractor and the critical stations stay usable
        immune = self.clip_immune_extractor or f"{resource_for_gear}_extractor"
        obj = cfg.game.objects.get(immune)
        if isinstance(obj, AssemblerConfig):
            obj.clip_immune = True
            obj.start_clipped = False
        for station_name in ("charger", "assembler", "chest"):
            obj = cfg.game.objects.get(station_name)
            if isinstance(obj, AssemblerConfig):
                obj.clip_immune = True
                obj.start_clipped = False


# --- standard levels (values transcribed from difficulty_variants.py:298+) ---

STANDARD = DifficultyLevel(
    name="standard",
    description="Baseline mission parameters (legacy medium)",
)

HARD = DifficultyLevel(
    name="hard",
    description="Tight extractor budgets and minimal passive regen",
    carbon_max_uses_override=4, oxygen_max_uses_override=4,
    germanium_max_uses_override=6, silicon_max_uses_override=3,
    carbon_eff_override=85, oxygen_eff_override=65,
    germanium_eff_override=75, silicon_eff_override=70,
    charger_eff_override=100,
    energy_regen_override=1,
    move_energy_cost_override=2,
    allow_agent_scaling=False,
)

SINGLE_USE = DifficultyLevel(
    name="single_use",
    description="Every extractor can be used exactly once - no second chances",
    carbon_max_uses_override=1, oxygen_max_uses_override=1,
    germanium_max_uses_override=1, silicon_max_uses_override=1,
    charger_eff_override=120,
    energy_regen_override=1,
    allow_agent_scaling=False,
)

SPEED_RUN = DifficultyLevel(
    name="speed_run",
    description="Short clock, cheap movement, efficient extraction",
    carbon_max_uses_override=6, oxygen_max_uses_override=6,
    germanium_max_uses_override=6, silicon_max_uses_override=6,
    carbon_eff_override=160, oxygen_eff_override=160,
    germanium_eff_override=160, silicon_eff_override=160,
    charger_eff_override=160,
    energy_regen_override=2,
    move_energy_cost_override=1,
    max_steps_override=600,
    allow_agent_scaling=True,
)

ENERGY_CRISIS = DifficultyLevel(
    name="energy_crisis",
    description="Minimal passive regen and weak chargers - plan every move",
    charger_eff_override=50,
    energy_regen_override=1,
    allow_agent_scaling=False,
)

CLIPPED_OXYGEN = DifficultyLevel(
    name="clipped_oxygen",
    description="Oxygen extractor starts clipped - craft decoder from carbon to unclip",
    clip_period=0, clip_target="oxygen",
    clip_immune_extractor="carbon_extractor",
    allow_agent_scaling=False,
)

CLIPPED_CARBON = DifficultyLevel(
    name="clipped_carbon",
    description="Carbon extractor starts clipped - craft modulator from oxygen to unclip",
    clip_period=0, clip_target="carbon",
    clip_immune_extractor="oxygen_extractor",
    allow_agent_scaling=False,
)

CLIPPED_GERMANIUM = DifficultyLevel(
    name="clipped_germanium",
    description="Germanium extractor starts clipped - craft resonator from silicon to unclip",
    clip_period=0, clip_target="germanium",
    clip_immune_extractor="silicon_extractor",
    allow_agent_scaling=False,
)

CLIPPED_SILICON = DifficultyLevel(
    name="clipped_silicon",
    description="Silicon extractor starts clipped - craft scrambler from germanium to unclip",
    clip_period=0, clip_target="silicon",
    clip_immune_extractor="germanium_extractor",
    allow_agent_scaling=False,
)

CLIPPING_CHAOS = DifficultyLevel(
    name="clipping_chaos",
    description="Random extractors clip over time - must craft unclip items reactively",
    clip_period=7, clip_target=None,
    allow_agent_scaling=False,
)

DIFFICULTY_VARIANTS: list[DifficultyLevel] = [
    STANDARD, HARD, SINGLE_USE, SPEED_RUN, ENERGY_CRISIS,
    CLIPPED_OXYGEN, CLIPPED_CARBON, CLIPPED_GERMANIUM, CLIPPED_SILICON,
    CLIPPING_CHAOS,
]


def get_difficulty(name: str) -> DifficultyLevel:
    return next(d for d in DIFFICULTY_VARIANTS if d.name == name)
