"""Benchmark dataset registry (port of `mtf_tpu/utils/datasets.py`).

Re-encodes the reference actor/sequence tables
(`Config/include/mtf/Config/datasets.h:6-929`) — pure data,
expressed via generators where the naming follows a pattern (TMT light x
object x speed; UCSB scene x motion). Sequences live on disk as
`<db_root>/<actor>/<sequence>/frame%05d.jpg` with GT at
`<db_root>/<actor>/<sequence>.txt` (objUtils.cc readGT conventions).
"""
from __future__ import annotations

_TMT_OBJECTS = ["bookI", "bookII", "bookIII", "cereal", "juice",
                "mugI", "mugII", "mugIII"]


def _tmt() -> list[str]:
    seqs = []
    for speed in ["s3", "s4"]:
        seqs += [f"nl_{o}_{speed}" for o in _TMT_OBJECTS]
    seqs += ["nl_bus", "nl_highlighting", "nl_letter", "nl_newspaper"]
    for speed in ["s1", "s2", "s5"]:
        seqs += [f"nl_{o}_{speed}" for o in _TMT_OBJECTS]
    seqs += [f"nl_{o}_si" for o in
             ["bookI", "bookII", "cereal", "juice", "mugI", "mugIII"]]
    for speed in ["s3", "s4"]:
        seqs += [f"dl_{o}_{speed}" for o in _TMT_OBJECTS]
    seqs += ["dl_bus", "dl_highlighting", "dl_letter", "dl_newspaper"]
    for speed in ["s1", "s2"]:
        seqs += [f"dl_{o}_{speed}" for o in _TMT_OBJECTS]
    seqs += [f"dl_{o}_s5" for o in
             ["bookI", "bookII", "bookIII", "cereal", "juice", "mugI",
              "mugIII"]]
    seqs += [f"dl_{o}_si" for o in
             ["bookII", "cereal", "juice", "mugI", "mugIII"]]
    seqs += ["dl_mugII_si", "dl_mugII_s5", "nl_mugII_si"]
    seqs += [f"robot_{o}" for o in _TMT_OBJECTS]
    return seqs


def _ucsb() -> list[str]:
    scenes = ["bricks", "building", "mission", "paris", "sunset", "wood"]
    motions = (["dynamic_lighting"] + [f"motion{i}" for i in range(1, 10)]
               + ["panning", "perspective", "rotation", "static_lighting",
                  "unconstrained", "zoom"])
    return [f"{s}_{m}" for s in scenes for m in motions]



_PTW_OBJECTS = ["Amish", "Burger", "BusStop", "Citibank", "Coke", "Fruit",
                "IndegoStation", "Lottery_1", "Lottery_2", "Map_1", "Map_2",
                "Map_3", "Melts", "NoStopping", "OneWay", "Painting_1",
                "Painting_2", "Pizza", "Poster_1", "Poster_2", "Pretzel",
                "ShuttleStop", "SmokeFree", "Snack", "Snap", "StopSign",
                "Sundae", "Sunoco", "WalkYourBike", "Woman"]


def _ptw() -> list[str]:
    return [f"{o}_{i}" for o in _PTW_OBJECTS for i in range(1, 8)]


def _metaio() -> list[str]:
    scenes = ["bump", "grass", "isetta", "lucent", "macMini",
              "philadelphia", "stop", "wall"]
    conds = ["angle", "fast_close", "fast_far", "illumination", "range"]
    return [f"{s}_{c}" for s in scenes for c in conds]


SEQUENCES = {
    "TMT": _tmt(),
    "UCSB": _ucsb(),
    "LinTrack": ["mouse_pad", "phone", "towel"],
    "LinTrackShort": ([f"mouse_pad_{i}" for i in range(1, 8)]
                      + [f"phone_{i}" for i in range(1, 4)]
                      + [f"towel_{i}" for i in range(1, 5)]),
    "PAMI": ["acronis", "bass", "bear", "board_robot", "board_robot_2",
             "book1", "book2", "book3", "book4", "box", "box_robot",
             "cat_cylinder", "cat_mask", "cat_plane", "compact_disc", "cube",
             "dft_atlas_moving", "dft_atlas_still", "dft_moving", "dft_still",
             "juice", "lemming", "mascot", "omni_magazine", "omni_obelix",
             "sylvester", "table_top", "tea"],
    "TMT_FINE": [f"{task}_{view}" for task in
                 ["fish_lure", "key_task", "hexagon_task"] for view in
                 ["left", "right", "fast_left", "fast_right"]]
                + [f"{task}_{view}" for task in
                   ["fish_lure", "fish_lure_fast", "key_task",
                    "key_task_fast", "hexagon_task", "hexagon_task_fast"]
                   for view in ["cam1", "cam2"]],
    "CMT": ["board_robot", "box_robot", "cup_on_table", "juice", "lemming",
            "liquor", "sylvester", "ball", "car", "car_2", "carchase",
            "dog1", "gym", "jumping", "mountain_bike", "person",
            "person_crossing", "person_partially_occluded", "singer",
            "track_running"],
    "VOT": ["woman", "ball", "basketball", "bicycle", "bolt", "car", "david",
            "diving", "drunk", "fernando", "fish1", "fish2", "gymnastics",
            "hand1", "hand2", "jogging", "motocross", "polarbear", "skating",
            "sphere", "sunshade", "surfing", "torus", "trellis", "tunnel"],
    "VIVID": ["pktest03", "egtest01", "egtest02", "egtest03", "egtest04",
              "egtest05", "pktest01", "pktest02", "redteam"],
    "PTW": _ptw(),
    "METAIO": _metaio(),
    "VOT16": ["bag", "ball1", "ball2", "basketball", "birds1", "birds2", "blanket",
              "bmx", "bolt1", "bolt2", "book", "butterfly", "car1", "car2",
              "crossing", "dinosaur", "fernando", "fish1", "fish2", "fish3", "fish4",
              "girl", "glove", "godfather", "graduate", "gymnastics1", "gymnastics2",
              "gymnastics3", "gymnastics4", "hand", "handball1", "handball2",
              "helicopter", "iceskater1", "iceskater2", "leaves", "marching",
              "matrix", "motocross1", "motocross2", "nature", "octopus",
              "pedestrian1", "pedestrian2", "rabbit", "racing", "road", "shaking",
              "sheep", "singer1", "singer2", "singer3", "soccer1", "soccer2",
              "soldier", "sphere", "tiger", "traffic", "tunnel", "wiper"],
    "VTB": ["Basketball", "Biker", "Bird1", "Bird2", "BlurBody", "BlurCar1",
            "BlurCar2", "BlurCar3", "BlurCar4", "BlurFace", "BlurOwl", "Board",
            "Bolt", "Bolt2", "Box", "Boy", "Car1", "Car2", "Car4", "Car24",
            "CarDark", "CarScale", "ClifBar", "Coke", "Couple", "Coupon",
            "Crossing", "Crowds", "Dancer", "Dancer2", "David", "David2", "David3",
            "Deer", "Diving", "Dog", "Dog1", "Doll", "DragonBaby", "Dudek",
            "FaceOcc1", "FaceOcc2", "Fish", "FleetFace", "Football", "Football1",
            "Freeman1", "Freeman3", "Freeman4", "Girl", "Girl2", "Gym", "Human2",
            "Human3", "Human4", "Human5", "Human6", "Human7", "Human8", "Human9",
            "Ironman", "Jogging", "Jogging_2", "Jump", "Jumping", "KiteSurf",
            "Lemming", "Liquor", "Man", "Matrix", "Mhyang", "MotorRolling",
            "MountainBike", "Panda", "RedTeam", "Rubik", "Shaking", "Singer1",
            "Singer2", "Skater", "Skater2", "Skating1", "Skating2", "Skating2_2",
            "Skiing", "Soccer", "Subway", "Surfer", "Suv", "Sylvester", "Tiger1",
            "Tiger2", "Toy", "Trans", "Trellis", "Twinnings", "Vase", "Walking",
            "Walking2", "Woman"],
    "TrakMark": ["CV00_00", "CV00_01", "CV00_02", "CV01_00", "FS00_00", "FS00_01",
                 "FS00_02", "FS00_03", "FS00_04", "FS00_05", "FS00_06", "FS01_00",
                 "FS01_01", "FS01_02", "FS01_03", "JR00_00", "JR00_01", "NC00_00",
                 "NC01_00", "NH00_00", "NH00_01"],
    "Mosaic": ["book_1", "book_2", "book_3", "book_4", "book_5", "book_6", "book_7",
               "book_8", "poster_1", "poster_2", "poster_3", "poster_4", "poster_5",
               "poster_6", "poster_7", "poster_8", "poster_9"],
    "Misc": ["uav_sim", "chess_board_1", "chess_board_2", "chess_board_3",
             "chess_board_4"],
    "Synthetic": ["bear", "board_robot", "book4", "box", "box_robot",
                  "building_dynamic_lighting", "cat_cylinder", "cube", "dft_still",
                  "lemming", "mission_dynamic_lighting", "mouse_pad", "nl_bookI_s3",
                  "nl_bus", "nl_cereal_s3", "nl_juice_s3", "nl_letter", "nl_mugI_s3",
                  "nl_newspaper", "paris_dynamic_lighting", "phone",
                  "sunset_dynamic_lighting", "sylvester", "towel",
                  "wood_dynamic_lighting"],
    "Live": [],
}

ACTORS = list(SEQUENCES)


def sequence_names(actor: str) -> list[str]:
    if actor not in SEQUENCES:
        raise ValueError(f"unknown actor {actor!r}; known: {ACTORS}")
    return SEQUENCES[actor]


def sequence_by_id(actor: str, seq_id: int) -> str:
    return sequence_names(actor)[seq_id]
