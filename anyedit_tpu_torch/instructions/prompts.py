"""Few-shot prompt banks + self-evaluation prompts per edit type.

A copy of `anyedit_tpu/instructions/prompts.py`, kept here because the JAX
package's `instructions/__init__` imports its generator, which reaches the
JAX Llama.

Same role as the reference's `few_example_dict` /
`get_content_instruction` / `instruction_evaluation`
(edit_instruction/prompt_generation_tool.py:6-348): given a source caption,
an instruction-tuned LLM emits {edit instruction, edited object, output
caption}; a second yes/no prompt re-checks the result's type fidelity.
Prompt text here is written fresh for this framework (the THRESHOLDS of
filters are ported exactly; prompt wording is not load-bearing).
"""

from __future__ import annotations

import random

# Each example: (input caption, edit instruction, edited object, output caption)
FEW_SHOT_BANK: dict[str, list[tuple[str, str, str, str]]] = {
    "add": [
        ("a wooden bench in a quiet park",
         "add a sleeping cat on the bench", "cat",
         "a wooden bench with a sleeping cat in a quiet park"),
        ("a sailboat on calm water",
         "add a lighthouse on the shore", "lighthouse",
         "a sailboat on calm water with a lighthouse on the shore"),
        ("a plate of spaghetti on a table",
         "add a glass of red wine beside the plate", "glass of red wine",
         "a plate of spaghetti and a glass of red wine on a table"),
        ("a man hiking along a mountain trail",
         "add a golden retriever walking beside him", "golden retriever",
         "a man hiking along a mountain trail with a golden retriever"),
        ("an empty street at dawn",
         "add a red bicycle leaning on a lamp post", "red bicycle",
         "an empty street at dawn with a red bicycle leaning on a lamp post"),
    ],
    "remove": [
        ("two cups and a teapot on a tray",
         "remove the teapot", "teapot", "two cups on a tray"),
        ("a laptop and a notebook on a desk",
         "remove the notebook", "notebook", "a laptop on a desk"),
        ("a flock of pigeons around a fountain",
         "remove the pigeons", "pigeons", "a fountain"),
        ("a truck parked next to a barn",
         "remove the truck", "truck", "a barn"),
        ("a painting and a clock on the wall",
         "remove the clock", "clock", "a painting on the wall"),
    ],
    "replace": [
        ("a bowl of apples on the counter",
         "replace the apples with oranges", "apples",
         "a bowl of oranges on the counter"),
        ("a horse grazing in the meadow",
         "replace the horse with a cow", "horse",
         "a cow grazing in the meadow"),
        ("a blue sedan in the driveway",
         "replace the sedan with a pickup truck", "sedan",
         "a pickup truck in the driveway"),
        ("a vase of tulips by the window",
         "replace the tulips with sunflowers", "tulips",
         "a vase of sunflowers by the window"),
        ("a kite flying over the beach",
         "replace the kite with a drone", "kite",
         "a drone flying over the beach"),
    ],
    "color_alter": [
        ("a red barn beside a corn field",
         "change the barn to blue", "barn",
         "a blue barn beside a corn field"),
        ("a woman holding a yellow umbrella",
         "make the umbrella green", "umbrella",
         "a woman holding a green umbrella"),
        ("a white ceramic mug on a saucer",
         "turn the mug black", "mug",
         "a black ceramic mug on a saucer"),
        ("a silver car parked by the curb",
         "change the car's color to orange", "car",
         "an orange car parked by the curb"),
        ("a brown leather couch in the living room",
         "make the couch gray", "couch",
         "a gray leather couch in the living room"),
    ],
    "appearance_alter": [
        ("a plain wooden door at the entrance",
         "carve ornate patterns into the door", "door",
         "an ornately carved wooden door at the entrance"),
        ("a cat sitting on the windowsill",
         "make the cat fluffy", "cat",
         "a fluffy cat sitting on the windowsill"),
        ("a concrete wall along the sidewalk",
         "cover the wall with ivy", "wall",
         "an ivy-covered wall along the sidewalk"),
        ("a glass of water on the table",
         "fill the glass with ice cubes", "glass",
         "a glass of ice water on the table"),
        ("a plain white t-shirt on a hanger",
         "add stripes to the t-shirt", "t-shirt",
         "a striped t-shirt on a hanger"),
    ],
    "background_change": [
        ("a golden retriever on a lawn",
         "change the background to a snowy field", "",
         "a golden retriever in a snowy field"),
        ("a cyclist riding on a city street",
         "change the background to a forest road", "",
         "a cyclist riding on a forest road"),
        ("a coffee cup on a kitchen counter",
         "set the scene on a beach at sunset", "",
         "a coffee cup on a beach at sunset"),
        ("a street performer in a plaza",
         "move the scene to a subway station", "",
         "a street performer in a subway station"),
        ("a parked motorcycle in a garage",
         "change the background to a desert highway", "",
         "a parked motorcycle on a desert highway"),
    ],
    "tone_transfer": [
        ("a harbor at midday",
         "make it look like sunset", "",
         "a harbor at sunset"),
        ("a forest path in summer",
         "turn the season to autumn", "",
         "a forest path in autumn with fallen leaves"),
        ("a city skyline on a clear day",
         "make the weather foggy", "",
         "a city skyline shrouded in fog"),
        ("a portrait in color",
         "convert the photo to black and white", "",
         "a black and white portrait"),
        ("a bright daytime street",
         "make it nighttime with neon lights", "",
         "a street at night lit by neon lights"),
    ],
    "action_change": [
        ("a dog sitting by the door",
         "make the dog jump", "dog",
         "a dog jumping by the door"),
        ("a man standing on the shore",
         "make the man run along the shore", "man",
         "a man running along the shore"),
        ("a ballerina posing on stage",
         "make the ballerina leap", "ballerina",
         "a ballerina leaping on stage"),
        ("a horse standing in a field",
         "make the horse gallop", "horse",
         "a horse galloping in a field"),
        ("a child sitting on a swing",
         "make the child swing high", "child",
         "a child swinging high on a swing"),
    ],
    "material_alter": [
        ("a ceramic vase on the shelf",
         "make the vase out of glass", "vase",
         "a glass vase on the shelf"),
        ("a wooden chair in the corner",
         "turn the chair into metal", "chair",
         "a metal chair in the corner"),
        ("a stone statue in the garden",
         "make the statue out of bronze", "statue",
         "a bronze statue in the garden"),
        ("a leather bag on the bench",
         "make the bag out of canvas", "bag",
         "a canvas bag on the bench"),
        ("a brick wall behind the cafe",
         "turn the wall into glass", "wall",
         "a glass wall behind the cafe"),
    ],
    "textual_change": [
        ('a storefront sign that reads "OPEN"',
         'change the sign text to "CLOSED"', "sign",
         'a storefront sign that reads "CLOSED"'),
        ('a t-shirt printed with "HELLO"',
         'change the print to "WORLD"', "t-shirt",
         'a t-shirt printed with "WORLD"'),
        ('a mug with the word "Monday"',
         'change the word to "Friday"', "mug",
         'a mug with the word "Friday"'),
        ('a banner saying "SALE"',
         'change the banner to say "GRAND OPENING"', "banner",
         'a banner saying "GRAND OPENING"'),
        ('a chalkboard with "Menu" written on it',
         'change the writing to "Specials"', "chalkboard",
         'a chalkboard with "Specials" written on it'),
    ],
    "implicit_change": [
        ("a lit candle on a cake",
         "the candle after someone blows it out", "candle",
         "a cake with a smoking, extinguished candle"),
        ("an ice cream cone on a hot day",
         "the ice cream after ten minutes in the sun", "ice cream",
         "a melting ice cream cone dripping down the cone"),
        ("a full glass of lemonade",
         "the glass after someone drinks most of it", "glass",
         "a nearly empty glass of lemonade"),
        ("a green banana on the counter",
         "the banana after a week", "banana",
         "a ripe yellow banana with brown spots on the counter"),
        ("a sandcastle at low tide",
         "the sandcastle after the tide comes in", "sandcastle",
         "a collapsed sandcastle washed over by waves"),
    ],
}

_TYPE_DESCRIPTION = {
    "add": "adds a plausible new object into the scene",
    "remove": "removes an existing object from the scene",
    "replace": "replaces one object with a different object",
    "color_alter": "changes the color of one object",
    "appearance_alter": "changes the appearance/texture of one object without replacing it",
    "background_change": "changes only the background/setting",
    "tone_transfer": "changes the global tone, weather, season or time of day",
    "action_change": "changes the action/pose of the subject",
    "material_alter": "changes the material an object is made of",
    "textual_change": "changes visible written text in the scene",
    "implicit_change": "describes the scene after a real-world process or event",
}


def system_prompt(edit_type: str) -> str:
    return (
        "You write image-editing data. Given the caption of an image, "
        f"produce one edit instruction that {_TYPE_DESCRIPTION[edit_type]}, "
        "the object being edited, and the caption of the edited image.\n"
        "Answer in exactly this format:\n"
        "instruction: <edit instruction>\n"
        "object: <edited object or none>\n"
        "output: <edited caption>"
    )


def few_shot_prompt(edit_type: str, caption: str, rng: random.Random,
                    n_shots: int = 5) -> str:
    bank = FEW_SHOT_BANK[edit_type]
    shots = rng.sample(bank, min(n_shots, len(bank)))
    parts = [system_prompt(edit_type), ""]
    for inp, edit, obj, out in shots:
        parts += [f"caption: {inp}", f"instruction: {edit}",
                  f"object: {obj or 'none'}", f"output: {out}", ""]
    parts += [f"caption: {caption}"]
    return "\n".join(parts)


def eval_prompt(edit_type: str, caption: str, instruction: str,
                output: str) -> str:
    """Self-check prompt: does the generated triple match the edit type?
    (instruction_evaluation, prompt_generation_tool.py:267-348)."""
    return (
        f"An edit of type '{edit_type}' should be one that "
        f"{_TYPE_DESCRIPTION[edit_type]}.\n"
        f"caption: {caption}\ninstruction: {instruction}\noutput: {output}\n"
        "Is the instruction a valid edit of this type, and is the output "
        "caption consistent with applying it? Answer yes or no."
    )


# ---- Omost-style canvas planning (composition_image_generation.py:40-62:
# the reference drives Omost-llama-3-8b for a canvas; here ANY harness LLM
# emits the parse_canvas_plan line format directly) ------------------------

CANVAS_PLAN_EXAMPLES: list[tuple[str, str]] = [
    ("a cozy living room with a dog",
     "global: a cozy living room, warm light, detailed\n"
     "region: 0.0,0.0,0.45,1.0 | a tall bookshelf full of books\n"
     "region: 0.45,0.35,1.0,0.95 | a sleeping golden retriever on a rug"),
    ("a harbor at sunset",
     "global: a harbor at sunset, dramatic sky\n"
     "region: 0.0,0.0,1.0,0.45 | orange and purple clouds over the horizon\n"
     "region: 0.1,0.45,0.6,0.95 | a moored fishing boat\n"
     "region: 0.6,0.5,1.0,1.0 | a stone pier with coiled ropes"),
    ("a chef plating dessert in a kitchen",
     "global: a professional kitchen, shallow depth of field\n"
     "region: 0.2,0.1,0.8,0.75 | a chef in whites plating a dessert\n"
     "region: 0.25,0.7,0.75,1.0 | a white plate with a chocolate tart"),
]


def canvas_plan_prompt(caption: str, rng: random.Random,
                       n_shots: int = 3) -> str:
    shots = rng.sample(CANVAS_PLAN_EXAMPLES,
                       min(n_shots, len(CANVAS_PLAN_EXAMPLES)))
    parts = [
        "Lay out a canvas for the scene. Answer with one 'global:' line "
        "giving the overall scene, then 2-4 'region: x1,y1,x2,y2 | "
        "description' lines with normalized coordinates in [0,1].", ""]
    for cap, plan in shots:
        parts += [f"caption: {cap}", plan, ""]
    parts += [f"caption: {caption}"]
    return "\n".join(parts)
