"""DCL (reference ``Examples/DCL.py``, ``configs/DCL.yaml``): the common
augmentation and the jigsaw collate that doubles each batch to
``[unswapped; swapped]`` (``data/dcl.py``), or with ``dataset.pipeline:
device`` the same on the card (``device_prepare_train``/``_eval``); a 10%
per-class val subsample of metadata-backed datasets; ``classifier``,
``classifier_swap`` and ``convmask`` at ``optimizer.lr_ratio`` (10) times
the base LR. The metrics count all 2B rows of a train batch."""

from ..data.dcl import (
    DCLCommonAug,
    DCLTrainCollate,
    DCLValCollate,
    make_dcl_device_augment,
    make_dcl_device_eval,
    subsample_per_class,
)
from ..engine import Trainer
from ..engine.optim import prefix_param_groups
from ..train import main


class DCLTrainer(Trainer):
    def _dcl_params(self):
        mcfg = self.config.model
        tcfg = self.config.dataset.transformer
        return {"grid": int(tcfg.get("swap_num", [7, 7])[0]),
                "cls_2": bool(mcfg.get("cls_2", True)),
                "num_classes": int(mcfg.num_classes)}

    def get_transformers(self, transformer_config):
        if self.pipeline == "device":
            return super().get_transformers(transformer_config)
        resize = int(transformer_config.get("resize_size", 512))
        crop = int(transformer_config.get("image_size", 448))
        return {"train": DCLCommonAug(resize, crop,
                                      rotate=float(transformer_config.get("rotate", 15))),
                "val": DCLCommonAug(resize, crop, train=False)}

    def get_collate_fn(self):
        if self.pipeline == "device":
            return super().get_collate_fn()
        p = self._dcl_params()
        return {"train": DCLTrainCollate(grid=p["grid"], cls_2=p["cls_2"],
                                         num_classes=p["num_classes"], seed=self.seed),
                "val": DCLValCollate(grid=p["grid"], cls_2=p["cls_2"])}

    def device_prepare_train(self, generator, batch):
        p = self._dcl_params()
        tcfg = self.config.dataset.transformer
        augment = make_dcl_device_augment(
            int(tcfg.image_size), rotate=float(tcfg.get("rotate", 15)),
            grid=p["grid"], cls_2=p["cls_2"], num_classes=p["num_classes"])
        return augment(generator, batch)

    def device_prepare_eval(self, batch):
        p = self._dcl_params()
        return make_dcl_device_eval(int(self.config.dataset.transformer.image_size),
                                    grid=p["grid"], cls_2=p["cls_2"])(batch)

    def get_dataset(self, ds_config):
        datasets = super().get_dataset(ds_config)
        val = datasets["val"]
        if hasattr(val, "paths"):  # a metadata-backed dataset
            keep = subsample_per_class(val.labels, fraction=0.1, seed=self.seed)
            val.labels = val.labels[keep]
            val.paths = [val.paths[i] for i in keep]
        return datasets

    def get_param_groups(self):
        ratio = float(self.config.train.optimizer.get("lr_ratio", 10.0))
        return prefix_param_groups(
            self.model, {"classifier": "head", "classifier_swap": "head",
                         "convmask": "head", "backbone": "base"},
            {"base": 1.0, "head": ratio}, default="base")


if __name__ == "__main__":
    main(trainer_cls=DCLTrainer)
