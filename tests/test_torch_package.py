"""Package-level contracts of the port (hawkeye_tpu_torch): it imports
nothing of JAX or of the JAX package, its entry points default to CUDA and
refuse to carry on without it, and its own copies of the config and registry
behave like the JAX package's."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import ast
import os

import pytest
import torch

from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu_torch import MODEL, Repository
from hawkeye_tpu_torch.config import setup_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hawkeye_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "hawkeye_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def example_trainers():
    """Example module name -> the Trainer class it defines, for every module
    of hawkeye_tpu_torch/examples."""
    import importlib
    import pkgutil

    from hawkeye_tpu_torch import examples
    from hawkeye_tpu_torch.engine import Trainer

    out = {}
    for info in pkgutil.iter_modules(examples.__path__):
        module = importlib.import_module(f"{examples.__name__}.{info.name}")
        own = [c for c in vars(module).values()
               if isinstance(c, type) and issubclass(c, Trainer)
               and c.__module__ == module.__name__]
        # a module may define a base beside its trainer (OSMENet's
        # BalancedSamplerTrainer): the trainer is the one no other extends
        [out[info.name]] = [c for c in own
                            if not any(o is not c and issubclass(o, c) for o in own)]
    return out


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and all(os.path.exists(f) for f in files)
    bad = {(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, bad


def test_trainer_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    from hawkeye_tpu_torch.engine import Trainer
    from hawkeye_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # the recipe's log_dir is relative
    cfg = setup_config(argv=["--config", os.path.join(ROOT, "configs",
                                                      "BCNN_S2.yaml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)
    assert not os.listdir(tmp_path)  # raised before making a log dir
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_entry_raises_without_cuda(tmp_path, monkeypatch):
    from hawkeye_tpu_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--config", os.path.join(ROOT, "configs", "BCNN_S1.yaml")])


def test_tester_and_test_entry_default_to_cuda_and_raise_without_it(
        tmp_path, monkeypatch):
    from hawkeye_tpu_torch import test
    from hawkeye_tpu_torch.engine import Tester

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["--config", os.path.join(ROOT, "configs", "test.yaml")]
    with pytest.raises(RuntimeError, match="CUDA"):
        Tester(setup_config(argv=argv))
    with pytest.raises(RuntimeError, match="CUDA"):
        test.main(argv)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", ["BCNN_S1.yaml", "BCNN_S2.yaml", "Baseline.yaml",
                                  "Baseline_synthetic.yaml", "test.yaml",
                                  "CBCNN_S1.yaml", "CBCNN_S2.yaml", "MPN.yaml",
                                  "PeerLearning_BCNN_S1.yaml",
                                  "PeerLearning_BCNN_S2.yaml", "PC_resnet50.yaml",
                                  "OSMENet.yaml", "APINet.yaml", "CIN.yaml",
                                  "CrossX.yaml", "InterpPartsNet.yaml", "S3N.yaml",
                                  "MGE_CNN.yaml"])
def test_config_copy_reads_recipes_like_jax(name):
    path = os.path.join(ROOT, "configs", name)
    port = setup_config(argv=["--config", path])
    ref = jax_setup_config(argv=["--config", path])
    assert port.to_dict() == ref.to_dict()
    assert str(port) == str(ref)
    assert port.is_frozen()
    with pytest.raises(AttributeError):
        port.model.stage = 3


def test_registry_copy():
    import hawkeye_tpu_torch.models  # noqa: F401

    assert "BCNN" in MODEL
    repo = Repository("x")
    repo.register(len, name="f")
    with pytest.raises(AssertionError):
        repo.register(len, name="f")
    with pytest.raises(KeyError, match="not found"):
        repo.get("g")


def test_cuda_wrappers_refuse_other_devices():
    from hawkeye_tpu_torch.ops import _build, fused_bilinear, pool

    meta = torch.empty((2, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pool.pool_fwd(meta)
    with pytest.raises(ValueError, match="CUDA"):
        fused_bilinear.gram_signed_sqrt_forward(meta.reshape(2, 16, 8))
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)


# recipe -> (model class, criterion class, Example module, the model's
# parameter-name prefixes)
RECIPES = {
    "CBCNN_S1.yaml": ("CBCNN", "CrossEntropyLoss", "CBCNN", {"backbone", "fc"}),
    "CBCNN_S2.yaml": ("CBCNN", "CrossEntropyLoss", "CBCNN", {"backbone", "fc"}),
    "MPN.yaml": ("MPN", "CrossEntropyLoss", "MPN",
                 {"backbone", "dr_conv", "dr_bn", "fc"}),
    "PeerLearning_BCNN_S1.yaml": ("PeerLearningNet", "PeerLearningLoss",
                                  "PeerLearning", {"base_model", "base_model2"}),
    "PeerLearning_BCNN_S2.yaml": ("PeerLearningNet", "PeerLearningLoss",
                                  "PeerLearning", {"base_model", "base_model2"}),
    "PC_resnet50.yaml": ("BaselineClassifier", "PairwiseConfusionLoss",
                         "PairConfusion", {"backbone", "fc"}),
    "OSMENet.yaml": ("OSMENet", "MAMCLoss", "OSMENet",
                     {"backbone", "osme_0", "osme_1", "part_fc_0", "part_fc_1", "fc"}),
    "APINet.yaml": ("APINet", "APINetLoss", "APINet",
                    {"backbone", "map1", "map2", "fc"}),
    "CIN.yaml": ("CIN", "CINLoss", "CIN",
                 {"backbone", "conv", "gate_fc", "classifier", "pair_head"}),
    "CrossX.yaml": ("CrossXNet", "CrossXLoss", "CrossX",
                    {"conv1", "bn1", "conv2_0", "conv2_1", "conv3_0", "conv3_1",
                     "bn3_0", "bn3_1", "fc_plty", "fc_ulti", "fc_cmbn"}
                    | {f"layer{i}_{j}" for i, n in enumerate((3, 4, 6, 3), 1)
                       for j in range(n)}),
    "InterpPartsNet.yaml": ("InterpParts", "InterpPartsLoss", "InterpPartsNet",
                            {"backbone", "grouping", "attconv_0", "attconv_1",
                             "attconv_out", "attconv_bn", "post_0", "post_1",
                             "post_2", "post_3", "groupingbn", "mylinear"}),
    "NTSNet.yaml": ("NTSNet", "NTSLoss", "NTSNet",
                    {"backbone", "fc", "proposal_net", "concat_net", "partcls_net"}),
    "APCNN.yaml": ("APCNN", "APCNNLoss", "APCNN",
                   {"conv1", "bn1", "p5_master", "p5_gpb", "p5_2", "p4_1", "p4_2",
                    "p3_1", "p3_2", "cls3", "cls4", "cls5", "cls_concate"}
                   | {f"a{lvl}_{k}" for lvl in (3, 4, 5) for k in ("spatial", "ch1", "ch2")}
                   | {f"layer{i}_{j}" for i, n in enumerate((3, 4, 6, 3), 1)
                      for j in range(n)}),
    "S3N.yaml": ("S3N", "MultiSmoothLoss", "S3N",
                 {"backbone", "raw_classifier", "sampler_buffer", "sampler_classifier",
                  "sampler_buffer1", "sampler_classifier1", "con_classifier", "radius",
                  "radius_inv", "blur_kernel"}),
    "MGE_CNN.yaml": ("MGECNN", "MGELoss", "MGE_CNN",
                     {"expert_0", "expert_1", "expert_2", "gate_backbone", "cls_gate_0",
                      "cls_gate_1"}),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_builds_on_cpu_with_its_registered_names(name):
    """The recipe's model, criterion and Example trainer are registered
    under the names the JAX package uses, and the model builds from the
    recipe at full width on the CPU."""
    from hawkeye_tpu_torch import LOSS
    from hawkeye_tpu_torch.losses import build_criterion
    from hawkeye_tpu_torch.models import build_model

    model_cls, loss_name, example, prefixes = RECIPES[name]
    cfg = setup_config(argv=["--config", os.path.join(ROOT, "configs", name)])
    model = build_model(cfg.model, cfg.dataset.transformer.image_size)
    assert type(model).__name__ == model_cls
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == prefixes
    assert all(p.device.type == "cpu" for p in model.parameters())
    crit = build_criterion(cfg.train.criterion)
    assert type(crit).__name__ == loss_name and LOSS.get(loss_name) is type(crit)
    assert example in example_trainers()
    if cfg.model.name == "CBCNN":
        assert model.fc.in_features == int(cfg.model.output_channel) == 6000
        assert model.irdft_cos.shape == (3001, 3001)
    if cfg.model.name == "PeerLearningNet":
        assert int(model.base_model.stage) == int(cfg.model.base_model.stage)
    if cfg.model.name == "OSMENet":  # ResNet-101's 7x7x2048 c5 at 224x224
        assert model.part_fc_0.weight.shape == (1024, 7 * 7 * 2048)
        assert len(model.backbone.stage_names[2]) == 23
    if cfg.model.name == "CIN":
        assert model.gate_fc.in_features == 2 * 7 * 7 * 2048
        assert model.pair_head.weight.shape == (512, 7 * 7 * 2048)
    if cfg.model.name == "NTSNet":  # 426 anchors at 224x224, one score each
        assert model.edge_anchors.shape == (426, 4) and model.adjacency.shape == (426, 426)
        assert model.concat_net.in_features == 5 * 2048 and model.proposal_num == 6
        assert type(model.backbone.bn1).__name__ == "GroupedBatchNorm"
    if cfg.model.name == "APCNN":  # 56x56, 28x28 and 14x14 grids at 448x448
        assert [getattr(model, f"anchors{i}").shape[0] for i in range(3)] == [3136, 784, 196]
        assert model.cls3.fc1.out_features == 512
    if cfg.model.name == "S3N":  # ResNet-50, 448x448, the 61x61 blur
        assert model.blur_kernel.shape == (61, 61, 1, 1) and model.image_size == 448
        assert model.fused_warp_pass and model.sampler_buffer.conv.weight.shape[0] == 2048
        assert type(model.backbone.bn1).__name__ == "GroupedBatchNorm"
    if cfg.model.name == "MGE_CNN":  # four ResNet-50s at 224x224, 10C part maps
        assert model.image_size == 224 and model.box_thred == 0.2
        assert model.expert_2.head.conv6.weight.shape == (2000, 1024, 1, 1)
        assert model.expert_0.head.cls_cat.in_features == 2048 + 2000
    if cfg.model.name == "IP_ResNet101":
        assert [len(n) for n in model.backbone.stage_names] == [3, 4, 23]
        assert model.grouping.weight.shape == (int(cfg.model.num_parts), 1024)


def test_example_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path, monkeypatch):
    from hawkeye_tpu_torch import train

    trainers = example_trainers()
    assert len(trainers) >= 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for trainer_cls in trainers.values():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--config", os.path.join(ROOT, "configs", "MPN.yaml")],
                       trainer_cls=trainer_cls)
    assert not os.listdir(tmp_path)



# JAX files whose port is not a file of the same path: the Pallas kernels
# are CUDA sources
PORTED_AS = {"ops/pallas_pool.py": "csrc/pool.cu",
             "ops/pallas_bilinear.py": "csrc/gram.cu"}


def test_every_jax_package_file_has_its_port():
    """Each file of hawkeye_tpu/ (Python and the native decoder's C++), of
    Examples/ and the train/test entry points maps to its port file: the
    same path under hawkeye_tpu_torch/ (examples/ for Examples/), or the
    CUDA source of a Pallas kernel. The native decoder's source is the
    port's own copy, and no module raises NotImplementedError but S3N on a
    VGG trunk (the JAX S3N reads a ``c5`` that its VGG does not give)."""
    jax_root = os.path.join(ROOT, "hawkeye_tpu")
    port_root = os.path.join(ROOT, "hawkeye_tpu_torch")
    pairs = []
    for d, _, names in os.walk(jax_root):
        for n in names:
            if n.endswith((".py", ".cpp")):
                rel = os.path.relpath(os.path.join(d, n), jax_root).replace(os.sep, "/")
                pairs.append((rel, PORTED_AS.get(rel, rel)))
    pairs += [(f"../Examples/{n}", f"examples/{n}")
              for n in os.listdir(os.path.join(ROOT, "Examples")) if n.endswith(".py")]
    pairs += [("../train.py", "train.py"), ("../test.py", "test.py")]
    assert len(pairs) > 90
    missing = [(j, p) for j, p in pairs if not os.path.exists(os.path.join(port_root, p))]
    assert not missing, missing
    with open(os.path.join(port_root, "data", "native", "decoder.cpp")) as f:
        src = f.read()
    assert "extern \"C\"" in src and "hawkeye_tpu/" not in src
    raising = []
    for path in _port_files():
        with open(path) as f:
            if "NotImplementedError" in f.read():
                raising.append(os.path.relpath(path, ROOT))
    assert raising == [os.path.join("hawkeye_tpu_torch", "models", "methods", "s3n.py")]
