"""Curses TUI of the port: menus that build and launch its CLIs.

    python -m mri_superresolution_torch.cli.ui

The port's copy of the JAX package's ``scripts/ui.py`` (reference
scripts/ui.py:87-1376): the same menus (main, extract, train, infer,
serve), parameter store, validation (ssim + perceptual weight sum <= 1 as
in :680-751, kspace crop factor in (0, 1]), toggles, dropdowns, checkpoint
picker, and a launcher that suspends curses, streams the child's
JSON-line protocol as readable progress and resumes the UI. Each menu
launches ``python -m mri_superresolution_torch.cli.{extract,train,infer,
serve}`` with the JAX TUI's flag lists, on the card unless the ``cpu``
toggle is on. The ``opt_shard`` toggle reaches a train CLI that runs it
(ZeRO-1), and the CLIs' default device count (``--num_devices`` 0)
trains data-parallel over, and serves on, every visible GPU. A
``spatial_shards`` > 1 trains and serves row-sharded over those GPUs (it
must divide their count).
"""

import curses
import json
import os
import random
import subprocess

from mri_superresolution_torch.models.families import jax_families
from mri_superresolution_torch.utils.subproc import child_env, cli_command

# the port's CLI module of each menu
CLI = {"extract_paired": "extract", "train": "train", "infer": "infer",
       "serve": "serve"}

BOOLEAN_FLAGS = ("augmentation", "use_tensorboard", "cpu",
                 "show_comparison", "show_diff", "resume")
DISCRETE = {
    "perceptual_loss_type": ["l1", "l2", "mse"],
    "vgg_layer_idx": [8, 17, 26, 35],  # relu2_2/3_4/4_4/5_4 in VGG19
    "model_type": jax_families(),
    "out_dtype": ["float32", "int16", "uint8"],
}

DEFAULT_PARAMS = {
    # extraction
    "datasets_dir": "./datasets",
    "hr_output_dir": "./training_data",
    "lr_output_dir": "./training_data_1.5T",
    "n_slices_extract": 10,
    "lower_percent": 0.2,
    "upper_percent": 0.8,
    "noise_std": 5.0,
    "target_size": "256 256",
    "kspace_crop_factor": 0.5,
    # training
    "full_res_dir": "./training_data",
    "low_res_dir": "./training_data_1.5T",
    "model_type": "unet",
    "base_filters": 32,
    "batch_size": 8,
    "epochs": 100,
    "learning_rate": 1e-4,
    "weight_decay": 1e-5,
    "ssim_weight": 0.3,
    "perceptual_weight": 0.0,
    "initial_alpha": 0.0,
    "vgg_layer_idx": 35,
    "perceptual_loss_type": "l1",
    "validation_split": 0.2,
    "patience": 10,
    "seed": random.randint(1, 10000),
    "augmentation": False,
    "remat": False,
    "spatial_shards": 1,
    "grad_accum": 1,
    "ema_decay": 0.0,
    "opt_shard": False,
    "qat": False,
    "save_every_steps": 0,
    "use_tensorboard": False,
    "cpu": False,
    "resume": False,
    "checkpoint_dir": "./checkpoints",
    "checkpoint_file": "",
    "log_dir": "./logs",
    # inference
    "input_image": "",
    "output_image": "output.png",
    "target_image": "",
    "show_comparison": True,
    "show_diff": True,
    "quant_int8": False,
    "tta": False,
    # serving daemon
    "serve_host": "127.0.0.1",
    "serve_port": 8476,
    "max_batch": 64,
    "batch_window_ms": 5.0,
    "artifact_file": "",
    # zero-copy transfer path (round 5)
    "serve_raw": False,
    "out_dtype": "float32",
}

MENUS = {
    "extract_paired": [
        "datasets_dir", "hr_output_dir", "lr_output_dir", "n_slices_extract",
        "lower_percent", "upper_percent", "target_size", "noise_std",
        "kspace_crop_factor", "cpu",
    ],
    "train": [
        "full_res_dir", "low_res_dir", "model_type", "base_filters",
        "batch_size", "epochs", "learning_rate", "weight_decay",
        "ssim_weight", "perceptual_weight", "perceptual_loss_type",
        "vgg_layer_idx", "initial_alpha", "validation_split", "patience",
        "seed", "augmentation", "remat", "spatial_shards", "grad_accum",
        "ema_decay", "opt_shard", "qat", "save_every_steps",
        "use_tensorboard", "resume", "cpu", "checkpoint_dir", "log_dir",
    ],
    "infer": [
        "input_image", "output_image", "target_image", "checkpoint_dir",
        "checkpoint_file", "model_type", "base_filters", "show_comparison",
        "show_diff", "quant_int8", "tta", "cpu",
    ],
    "serve": [
        "checkpoint_dir", "checkpoint_file", "artifact_file", "model_type",
        "base_filters", "serve_host", "serve_port", "max_batch",
        "batch_window_ms", "spatial_shards", "quant_int8", "tta",
        "serve_raw", "out_dtype", "cpu",
    ],
}


def validate(field, raw, params):
    """Typed validation (reference scripts/ui.py:680-751). Returns the
    parsed value or raises ValueError."""
    current = DEFAULT_PARAMS.get(field, "")
    if field in ("ssim_weight", "perceptual_weight"):
        v = float(raw)
        if not 0 <= v <= 1:
            raise ValueError(f"{field} must be in [0, 1]")
        other = ("perceptual_weight" if field == "ssim_weight"
                 else "ssim_weight")
        if v + float(params[other]) > 1:
            raise ValueError("ssim_weight + perceptual_weight must be <= 1")
        return v
    if field == "kspace_crop_factor":
        v = float(raw)
        if not 0 < v <= 1:
            raise ValueError("kspace_crop_factor must be in (0, 1]")
        return v
    if field in ("lower_percent", "upper_percent", "validation_split"):
        v = float(raw)
        if not 0 <= v <= 1:
            raise ValueError(f"{field} must be in [0, 1]")
        return v
    if field == "target_size":
        parts = raw.split()
        if len(parts) != 2 or not all(p.isdigit() for p in parts):
            raise ValueError("target_size must be two integers: 'W H'")
        return raw
    if isinstance(current, bool):
        return raw in ("1", "true", "True", "yes")
    if isinstance(current, int):
        v = int(raw)
        if field in ("batch_size", "epochs", "base_filters", "patience",
                     "n_slices_extract", "spatial_shards",
                     "grad_accum", "serve_port", "max_batch") and v <= 0:
            raise ValueError(f"{field} must be positive")
        return v
    if isinstance(current, float):
        v = float(raw)
        if field == "ema_decay" and not 0.0 <= v < 1.0:
            raise ValueError("ema_decay must be in [0, 1)")
        return v
    return raw


def build_command(menu, p):
    """Translate the param store into a CLI invocation (reference
    scripts/ui.py:853-1029): the JAX TUI's flags, after the port's
    module."""
    if menu not in CLI:
        raise ValueError(menu)
    cmd = cli_command(CLI[menu])
    if menu == "extract_paired":
        cmd += [
            "--datasets_dir", p["datasets_dir"],
            "--hr_output_dir", p["hr_output_dir"],
            "--lr_output_dir", p["lr_output_dir"],
            "--n_slices", str(p["n_slices_extract"]),
            "--lower_percent", str(p["lower_percent"]),
            "--upper_percent", str(p["upper_percent"]),
            "--target_size", *p["target_size"].split(),
            "--noise_std", str(p["noise_std"]),
            "--kspace_crop_factor", str(p["kspace_crop_factor"])]
    elif menu == "train":
        cmd += [
            "--full_res_dir", p["full_res_dir"],
            "--low_res_dir", p["low_res_dir"],
            "--model_type", p["model_type"],
            "--base_filters", str(p["base_filters"]),
            "--batch_size", str(p["batch_size"]),
            "--epochs", str(p["epochs"]),
            "--learning_rate", str(p["learning_rate"]),
            "--weight_decay", str(p["weight_decay"]),
            "--ssim_weight", str(p["ssim_weight"]),
            "--perceptual_weight", str(p["perceptual_weight"]),
            "--perceptual_loss_type", p["perceptual_loss_type"],
            "--vgg_layer_idx", str(p["vgg_layer_idx"]),
            "--initial_alpha", str(p["initial_alpha"]),
            "--validation_split", str(p["validation_split"]),
            "--patience", str(p["patience"]),
            "--seed", str(p["seed"]),
            "--spatial_shards", str(p["spatial_shards"]),
            "--grad_accum", str(p["grad_accum"]),
            "--ema_decay", str(p["ema_decay"]),
            "--save_every_steps", str(p["save_every_steps"]),
            "--checkpoint_dir", p["checkpoint_dir"],
            "--log_dir", p["log_dir"]]
        for flag in ("augmentation", "remat", "opt_shard", "qat",
                     "use_tensorboard", "resume"):
            if p[flag]:
                cmd.append(f"--{flag}")
    elif menu == "infer":
        cmd += [
            "--input", p["input_image"],
            "--output", p["output_image"],
            "--checkpoint_dir", p["checkpoint_dir"],
            "--model_type", p["model_type"],
            "--base_filters", str(p["base_filters"])]
        if p["target_image"]:
            cmd += ["--target", p["target_image"]]
        if p["checkpoint_file"]:
            cmd += ["--checkpoint_path", p["checkpoint_file"]]
        if p["show_comparison"]:
            cmd.append("--show_comparison")
        if p["show_diff"]:
            cmd.append("--show_diff")
        if p["quant_int8"]:
            cmd += ["--quant", "int8"]
        if p["tta"]:
            cmd.append("--tta")
    elif menu == "serve":
        cmd += [
            "--checkpoint_dir", p["checkpoint_dir"],
            "--model_type", p["model_type"],
            "--base_filters", str(p["base_filters"]),
            "--host", p["serve_host"],
            "--port", str(p["serve_port"]),
            "--max_batch", str(p["max_batch"]),
            "--batch_window_ms", str(p["batch_window_ms"])]
        if p["artifact_file"]:
            cmd += ["--artifact", p["artifact_file"]]
        if p["checkpoint_file"]:
            cmd += ["--checkpoint_path", p["checkpoint_file"]]
        if p["spatial_shards"] != 1:
            cmd += ["--spatial_shards", str(p["spatial_shards"])]
        if p["quant_int8"]:
            cmd += ["--quant", "int8"]
        if p["tta"]:
            cmd.append("--tta")
        if p["serve_raw"]:
            cmd.append("--serve_raw")
        if p["out_dtype"] != "float32":
            cmd += ["--out_dtype", p["out_dtype"]]
    if p["cpu"]:
        cmd.append("--cpu")
    return cmd


def run_subprocess(stdscr, cmd):
    """Suspend curses, stream the child (rendering protocol JSON lines as
    readable progress), resume curses (reference scripts/ui.py:847-1060)."""
    curses.endwin()
    print("\n" + "=" * 70)
    print("Running:", " ".join(cmd))
    print("=" * 70, flush=True)
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=child_env())
        for line in proc.stdout:
            line = line.rstrip("\n")
            try:
                msg = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                print(line, flush=True)
                continue
            t = msg.get("type")
            if t == "batch_update":
                print(f"\r  epoch {msg['epoch'] + 1} batch "
                      f"{msg['batch'] + 1}/{msg['total_batches']} "
                      f"loss {msg['loss']:.4f}   ", end="", flush=True)
            elif t == "epoch_summary":
                print(f"\n[epoch {msg['epoch'] + 1}/{msg['total_epochs']}] "
                      f"train_loss={msg['train_loss']:.4f} "
                      f"val_loss={msg.get('val_loss')} "
                      f"val_ssim={msg.get('val_ssim')} "
                      f"({msg.get('elapsed', 0):.1f}s)", flush=True)
            elif t == "params":
                pass
            else:
                print(msg.get("message", line), flush=True)
        code = proc.wait()
        status = ("completed successfully" if code == 0
                  else f"FAILED (exit {code})")
    except Exception as e:  # shown in the status line
        status = f"FAILED ({e})"
    print(f"\n=== Process {status}. Press Enter to return to the menu ===")
    try:
        input()
    except EOFError:
        pass
    stdscr.clear()
    curses.doupdate()
    return status


def pick_from_list(stdscr, title, items):
    """Simple picker overlay (checkpoint/model picker,
    reference scripts/ui.py:1062-1230)."""
    if not items:
        return None
    idx = 0
    while True:
        stdscr.clear()
        h, w = stdscr.getmaxyx()
        stdscr.addstr(0, max(0, (w - len(title)) // 2), title,
                      curses.A_BOLD)
        for i, item in enumerate(items[:h - 4]):
            attr = curses.A_REVERSE if i == idx else curses.A_NORMAL
            stdscr.addstr(2 + i, 2, str(item)[:w - 4], attr)
        stdscr.addstr(h - 1, 2, "Enter: select | Esc/q: cancel")
        stdscr.refresh()
        ch = stdscr.getch()
        if ch in (curses.KEY_UP, ord('k')):
            idx = (idx - 1) % len(items)
        elif ch in (curses.KEY_DOWN, ord('j')):
            idx = (idx + 1) % len(items)
        elif ch in (10, 13, curses.KEY_ENTER):
            return items[idx]
        elif ch in (27, ord('q')):
            return None


class MRIUI:
    def __init__(self, stdscr):
        self.stdscr = stdscr
        curses.start_color()
        curses.use_default_colors()
        for i, color in enumerate((curses.COLOR_WHITE, curses.COLOR_BLUE,
                                   curses.COLOR_GREEN, curses.COLOR_RED,
                                   curses.COLOR_YELLOW, curses.COLOR_CYAN), 1):
            curses.init_pair(i, color, -1)
        curses.curs_set(0)
        self.stdscr.keypad(True)
        self.params = dict(DEFAULT_PARAMS)
        self.menu = "main"
        self.idx = 0
        self.status = ""
        self.error = ""

    # ------------------------------------------------------------ drawing

    def options(self):
        if self.menu == "main":
            return ["Extract Paired Slices", "Train Super-Resolution Model",
                    "Infer on Image", "Start Inference Server", "Exit"]
        return MENUS[self.menu] + ["▶ Run", "◀ Back"]

    def draw(self):
        self.stdscr.erase()
        h, w = self.stdscr.getmaxyx()
        title = "MRI Super-Resolution Tool (GPU)"
        self.stdscr.addstr(0, max(0, (w - len(title)) // 2), title,
                           curses.color_pair(2) | curses.A_BOLD)
        self.stdscr.addstr(1, 0, "=" * (w - 1))
        opts = self.options()
        for i, opt in enumerate(opts):
            if 3 + i >= h - 3:
                break
            attr = curses.A_REVERSE if i == self.idx else curses.A_NORMAL
            if self.menu == "main":
                self.stdscr.addstr(3 + i, 4, opt, attr)
            else:
                if opt.startswith("▶") or opt.startswith("◀"):
                    self.stdscr.addstr(3 + i, 4, opt,
                                       attr | curses.color_pair(3))
                else:
                    val = self.params[opt]
                    tag = (" [toggle]" if opt in BOOLEAN_FLAGS else
                           " [select]" if opt in DISCRETE or
                           opt == "checkpoint_file" else "")
                    line = f"{opt:<24} = {val!s:<20}{tag}"
                    self.stdscr.addstr(3 + i, 4, line[:w - 6], attr)
        self.stdscr.addstr(h - 3, 0, "=" * (w - 1))
        if self.error:
            self.stdscr.addstr(h - 2, 0, f" ERROR: {self.error} "[:w - 1],
                               curses.color_pair(4))
        elif self.status:
            self.stdscr.addstr(h - 2, 0, f" {self.status} "[:w - 1],
                               curses.color_pair(3))
        controls = "↑/↓: Navigate | Enter: Select | Q: Quit"
        self.stdscr.addstr(h - 1, max(0, (w - len(controls)) // 2), controls)
        self.stdscr.refresh()

    # ------------------------------------------------------------ editing

    def edit_field(self, field):
        self.error = ""
        if field in BOOLEAN_FLAGS:
            self.params[field] = not self.params[field]
            return
        if field in DISCRETE:
            choice = pick_from_list(self.stdscr, f"Select {field}",
                                    DISCRETE[field])
            if choice is not None:
                self.params[field] = choice
            return
        if field == "checkpoint_file":
            d = self.params["checkpoint_dir"]
            files = []
            if os.path.isdir(d):
                files = sorted(f for f in os.listdir(d)
                               if f.endswith((".ckpt", ".pth", ".msgpack")))
            choice = pick_from_list(self.stdscr,
                                    f"Checkpoints in {d}", ["<none>"] + files)
            if choice is not None:
                self.params[field] = "" if choice == "<none>" else \
                    os.path.join(d, choice)
            return
        # free-text input (hand-rolled so both Enter codes \r and \n finish —
        # curses getstr only stops on \n, which hangs under cbreak terminals)
        curses.curs_set(1)
        h, w = self.stdscr.getmaxyx()
        prompt = f"New value for {field} (empty = keep): "
        self.stdscr.addstr(h - 2, 0, prompt.ljust(w - 1),
                           curses.color_pair(5))
        self.stdscr.refresh()
        buf = []
        while True:
            ch = self.stdscr.getch()
            if ch in (10, 13, curses.KEY_ENTER):
                break
            if ch in (27,):  # Esc cancels
                buf = []
                break
            if ch in (curses.KEY_BACKSPACE, 127, 8):
                if buf:
                    buf.pop()
            elif 32 <= ch < 127:
                buf.append(chr(ch))
            self.stdscr.addstr(h - 2, len(prompt),
                               ("".join(buf)).ljust(w - len(prompt) - 2))
            self.stdscr.refresh()
        raw = "".join(buf)
        curses.curs_set(0)
        if raw.strip():
            try:
                self.params[field] = validate(field, raw.strip(), self.params)
                self.status = f"{field} set to {self.params[field]}"
            except ValueError as e:
                self.error = str(e)

    # --------------------------------------------------------------- loop

    def run(self):
        while True:
            self.draw()
            ch = self.stdscr.getch()
            opts = self.options()
            # NOTE: bare ESC is deliberately NOT a back-key — arrow keys
            # arrive as ESC-prefixed sequences and on slow terminals curses
            # can deliver the ESC alone first, which would bounce the menu.
            if ch in (ord('q'), ord('Q')) and self.menu == "main":
                return
            if ch in (ord('q'), ord('Q')):
                self.menu, self.idx = "main", 0
                continue
            if ch in (curses.KEY_UP, ord('k')):
                self.idx = (self.idx - 1) % len(opts)
            elif ch in (curses.KEY_DOWN, ord('j')):
                self.idx = (self.idx + 1) % len(opts)
            elif ch in (10, 13, curses.KEY_ENTER):
                sel = opts[self.idx]
                if self.menu == "main":
                    self.menu = {0: "extract_paired", 1: "train",
                                 2: "infer", 3: "serve"}.get(self.idx,
                                                             "main")
                    if self.idx == 4:
                        return
                    self.idx = 0
                elif sel == "◀ Back":
                    self.menu, self.idx = "main", 0
                elif sel == "▶ Run":
                    err = self._precheck()
                    if err:
                        self.error = err
                        continue
                    cmd = build_command(self.menu, self.params)
                    self.status = run_subprocess(self.stdscr, cmd)
                    self.error = ""
                else:
                    self.edit_field(sel)

    def _precheck(self):
        if self.menu == "infer" and not self.params["input_image"]:
            return "input_image is required"
        if self.menu == "train":
            if (self.params["ssim_weight"] +
                    self.params["perceptual_weight"]) > 1:
                return "ssim_weight + perceptual_weight must be <= 1"
        return ""


def main(stdscr):
    MRIUI(stdscr).run()


if __name__ == "__main__":
    curses.wrapper(main)
