"""Built-in multimodal benchmark task configs.

The reference ships ~75 yaml task families (evaluate/lmms_eval/tasks/*,
docs/current_tasks.md). This module registers the core visual-instruction
benchmarks the CompeteSMoE paper evaluates on as TaskConfigs backed by HF
datasets (downloaded on first use; offline runs can pass explicit `docs`).

Each config mirrors the reference task's doc_to_text/doc_to_target
conventions (evaluate/lmms_eval/tasks/<name>/*.yaml + utils.py).

The port's own copy of competesmoe_tpu/eval/tasks_builtin.py: it imports
neither JAX nor that package.
"""

from __future__ import annotations

from typing import Dict

from .task import TaskConfig, register_task


def _visual(key="image"):
    def fn(doc):
        img = doc.get(key)
        return [img.convert("RGB")] if img is not None else []
    return fn


def _register_all() -> Dict[str, TaskConfig]:
    configs = {}

    configs["pope"] = register_task("pope", TaskConfig(
        task="pope", dataset_path="lmms-lab/POPE", test_split="test",
        output_type="generate_until",
        doc_to_text=lambda d: (d["question"]
                               + "\nAnswer the question using a single "
                                 "word or phrase."),
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answer"],
        generation_kwargs={"max_new_tokens": 16},
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    # MME: paired yes/no probes; per-category acc + acc_plus summed into
    # perception (max 2000) / cognition (max 800) scores
    # (tasks/mme/utils.py:8-126; the reference's "percetion" typo is kept
    # for metric-channel parity)
    _MME_PERCEPTION = {"existence", "count", "position", "color",
                       "posters", "celebrity", "scene", "landmark",
                       "artwork", "OCR"}

    def _mme_results(doc, resps):
        from .metrics import mme_parse_pred
        gt = str(doc["answer"]).lower().strip().replace(".", "")
        score = float(mme_parse_pred(resps[0]) == gt)
        cat = doc.get("category", "")
        key = "mme_percetion_score" if cat in _MME_PERCEPTION \
            else "mme_cognition_score"
        return {key: {"question_id": doc.get("question_id", ""),
                      "category": cat, "score": score}}

    configs["mme"] = register_task("mme", TaskConfig(
        task="mme", dataset_path="lmms-lab/MME", test_split="test",
        output_type="generate_until",
        doc_to_text=lambda d: d["question"],
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answer"],
        process_results=_mme_results,
        generation_kwargs={"max_new_tokens": 16},
        metric_list=[{"metric": "mme_percetion_score",
                      "aggregation": "mme"},
                     {"metric": "mme_cognition_score",
                      "aggregation": "mme"}]))

    configs["textvqa_val"] = register_task("textvqa_val", TaskConfig(
        task="textvqa_val", dataset_path="lmms-lab/textvqa",
        test_split="validation", output_type="generate_until",
        doc_to_text=lambda d: (d["question"]
                               + "\nAnswer the question using a single "
                                 "word or phrase."),
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answers"][0] if d.get("answers")
        else "",
        generation_kwargs={"max_new_tokens": 16},
        metric_list=[{"metric": "anls", "aggregation": "mean"}]))

    configs["gqa"] = register_task("gqa", TaskConfig(
        task="gqa", dataset_path="lmms-lab/GQA",
        dataset_name="testdev_balanced_instructions",
        test_split="testdev", output_type="generate_until",
        doc_to_text=lambda d: (d["question"]
                               + "\nAnswer the question using a single "
                                 "word or phrase."),
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answer"],
        generation_kwargs={"max_new_tokens": 16},
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    configs["scienceqa_img"] = register_task("scienceqa_img", TaskConfig(
        task="scienceqa_img", dataset_path="lmms-lab/ScienceQA",
        dataset_name="ScienceQA-IMG", test_split="test",
        output_type="generate_until",
        doc_to_text=lambda d: (
            d["question"] + "\n"
            + "\n".join(f"{chr(65 + i)}. {c}"
                        for i, c in enumerate(d["choices"]))
            + "\nAnswer with the option's letter from the given choices "
              "directly."),
        doc_to_visual=_visual(),
        doc_to_target=lambda d: chr(65 + d["answer"]),
        generation_kwargs={"max_new_tokens": 4},
        filter_list=[{"filter": "take_first_line"},
                     {"filter": "strip"}],
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    letter_prompt = ("\nAnswer with the option's letter from the given "
                     "choices directly.")

    def _mmbench_text(d):
        """hint + question + lettered options (ref mmbench/en_utils.py:42-62)."""
        opts = [f"{c}. {d[c]}" for c in "ABCDE"
                if d.get(c) not in (None, "", "nan")]
        hint = d.get("hint")
        parts = ([hint] if hint and str(hint) != "nan" else []) \
            + [d["question"], "\n".join(opts)]
        return " ".join(parts) + letter_prompt

    # MMBench language/split variants share one format
    # (tasks/mmbench/*.yaml: en/cn x dev/test, + the cc subset)
    for name, dname, split, group in (
        ("mmbench_en_dev", "en", "dev", "paper_core"),
        ("mmbench_en_test", "en", "test", None),
        ("mmbench_cn_dev", "cn", "dev", None),
        ("mmbench_cn_test", "cn", "test", None),
        ("mmbench_cn_cc", "cc", "test", None),
    ):
        configs[name] = register_task(name, TaskConfig(
            task=name, dataset_path="lmms-lab/MMBench",
            dataset_name=dname, test_split=split,
            output_type="generate_until", group=group,
            doc_to_text=_mmbench_text,
            doc_to_visual=_visual(),
            doc_to_target=lambda d: d["answer"],
            generation_kwargs={"max_new_tokens": 4},
            filter_list=[{"filter": "take_first_line"},
                         {"filter": "strip"}],
            metric_list=[{"metric": "exact_match",
                          "aggregation": "mean"}]))

    def _mmmu_text(d):
        """question + parsed options (ref tasks/mmmu/utils.py)."""
        import ast
        opts = d.get("options")
        if isinstance(opts, str):
            try:
                opts = ast.literal_eval(opts)
            except (ValueError, SyntaxError):
                opts = [opts]
        lines = "\n".join(f"{chr(65 + i)}. {o}"
                          for i, o in enumerate(opts or []))
        return f"{d['question']}\n{lines}{letter_prompt}"

    configs["mmmu_val"] = register_task("mmmu_val", TaskConfig(
        task="mmmu_val", dataset_path="lmms-lab/MMMU",
        test_split="validation", output_type="generate_until",
        group="paper_core",
        doc_to_text=_mmmu_text,
        doc_to_visual=_visual("image_1"),
        doc_to_target=lambda d: d["answer"],
        generation_kwargs={"max_new_tokens": 16},
        filter_list=[{"filter": "take_first_line"}, {"filter": "strip"}],
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    # MMMU-Pro standard split + CMMMU (Chinese MMMU) reuse the MMMU
    # option-parsing format (tasks/mmmu_pro/*.yaml, tasks/cmmmu/*.yaml)
    configs["mmmu_pro_standard"] = register_task(
        "mmmu_pro_standard", TaskConfig(
            task="mmmu_pro_standard", dataset_path="MMMU/MMMU_Pro",
            dataset_name="standard", test_split="test",
            output_type="generate_until",
            doc_to_text=_mmmu_text,
            doc_to_visual=_visual("image_1"),
            doc_to_target=lambda d: d["answer"],
            generation_kwargs={"max_new_tokens": 16},
            filter_list=[{"filter": "take_first_line"},
                         {"filter": "strip"}],
            metric_list=[{"metric": "exact_match",
                          "aggregation": "mean"}]))

    configs["cmmmu_val"] = register_task("cmmmu_val", TaskConfig(
        task="cmmmu_val", dataset_path="lmms-lab/CMMMU",
        test_split="val", output_type="generate_until",
        doc_to_text=lambda d: (
            f"{d['question']}\n"
            + "\n".join(f"{c}. {d.get(f'option{i}', '')}"
                        for i, c in enumerate("ABCD", 1)
                        if d.get(f"option{i}"))
            + "\n请直接回答选项字母。"),
        doc_to_visual=_visual("image_1"),
        doc_to_target=lambda d: d["answer"],
        generation_kwargs={"max_new_tokens": 16},
        filter_list=[{"filter": "take_first_line"}, {"filter": "strip"}],
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    configs["mathvista_testmini"] = register_task(
        "mathvista_testmini", TaskConfig(
            task="mathvista_testmini", dataset_path="AI4Math/MathVista",
            test_split="testmini", output_type="generate_until",
            group="paper_core",
            doc_to_text=lambda d: d["query"],
            doc_to_visual=_visual("decoded_image"),
            doc_to_target=lambda d: str(d["answer"]),
            generation_kwargs={"max_new_tokens": 32},
            filter_list=[{"filter": "take_first_line"},
                         {"filter": "strip"}],
            metric_list=[{"metric": "exact_match",
                          "aggregation": "mean"}]))

    def _seed_text(d):
        opts = [d.get(f"choice_{c}") for c in "abcd"]
        lines = "\n".join(f"{chr(65 + i)}. {o}"
                          for i, o in enumerate(opts) if o is not None)
        return f"{d['question']}\n{lines}{letter_prompt}"

    configs["seedbench"] = register_task("seedbench", TaskConfig(
        task="seedbench", dataset_path="lmms-lab/SEED-Bench",
        test_split="test", output_type="generate_until",
        group="paper_core",
        doc_to_text=_seed_text,
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answer"],
        generation_kwargs={"max_new_tokens": 4},
        filter_list=[{"filter": "take_first_line"}, {"filter": "strip"}],
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    configs["seedbench_2"] = register_task("seedbench_2", TaskConfig(
        task="seedbench_2", dataset_path="lmms-lab/SEED-Bench-2",
        test_split="test", output_type="generate_until",
        doc_to_text=_seed_text,
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answer"],
        generation_kwargs={"max_new_tokens": 4},
        filter_list=[{"filter": "take_first_line"}, {"filter": "strip"}],
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    def _ai2d_text(d):
        """mcq format with the llava letter post-prompt
        (ref tasks/ai2d/utils.py:6-14)."""
        choices = d["options"]
        lines = "\n".join(f"{chr(65 + i)}. {c}"
                          for i, c in enumerate(choices))
        return f"{d['question']}\n{lines}{letter_prompt}"

    configs["ai2d"] = register_task("ai2d", TaskConfig(
        task="ai2d", dataset_path="lmms-lab/ai2d", test_split="test",
        output_type="generate_until", group="paper_core",
        doc_to_text=_ai2d_text,
        doc_to_visual=_visual(),
        doc_to_target=lambda d: chr(65 + int(d["answer"]))
        if str(d["answer"]).isdigit() else str(d["answer"]),
        generation_kwargs={"max_new_tokens": 4},
        filter_list=[{"filter": "take_first_line"}, {"filter": "strip"}],
        metric_list=[{"metric": "exact_match", "aggregation": "mean"}]))

    single_word = ("\nAnswer the question using a single word or "
                   "phrase.")

    def _list_target(d, k):
        """Keep ALL ground-truth strings (anls / vqa_accuracy /
        ocrbench_accuracy take the best over references)."""
        v = d.get(k)
        if isinstance(v, (list, tuple)):
            return [str(x) for x in v]
        return str(v)

    # short-answer QA tasks (reference tasks/<name>/*.yaml dataset specs;
    # metric choices mirror the per-task utils: anls for Doc/Info/ST-VQA,
    # EvalAI consensus accuracy for VQAv2/VizWiz/OK-VQA, relaxed
    # correctness for ChartQA, containment for OCRBench)
    for name, path, dname, split, q_key, a_key, img_key, metric in (
        ("docvqa_val", "lmms-lab/DocVQA", "DocVQA", "validation",
         "question", "answers", "image", "anls"),
        ("infovqa_val", "lmms-lab/DocVQA", "InfographicVQA", "validation",
         "question", "answers", "image", "anls"),
        ("stvqa", "lmms-lab/ST-VQA", None, "test", "question", "answers",
         "image", "anls"),
        ("chartqa", "lmms-lab/ChartQA", None, "test", "question",
         "answer", "image", "relaxed_accuracy"),
        ("vqav2_val", "lmms-lab/VQAv2", None, "validation", "question",
         "answers", "image", "vqa_accuracy"),
        ("vizwiz_vqa_val", "lmms-lab/VizWiz-VQA", None, "val", "question",
         "answers", "image", "vqa_accuracy"),
        ("ok_vqa_val2014", "lmms-lab/OK-VQA", None, "val2014", "question",
         "answers", "image", "vqa_accuracy"),
        ("realworldqa", "lmms-lab/RealWorldQA", None, "test", "question",
         "answer", "image", "exact_match"),
        ("ocrbench", "echo840/OCRBench", None, "test", "question",
         "answer", "image", "ocrbench_accuracy"),
        ("iconqa_test", "lmms-lab/ICON-QA", None, "test", "question",
         "answers", "query_image", "anls"),
    ):
        def _target(d, k=a_key):
            v = _list_target(d, k)
            # VQAv2/OK-VQA store annotator dicts [{"answer": ...}, ...]
            if isinstance(v, list):
                return [x["answer"] if isinstance(x, dict) else x
                        for x in (d.get(k) or [])] or [""]
            return v

        configs[name] = register_task(name, TaskConfig(
            task=name, dataset_path=path, dataset_name=dname,
            test_split=split, output_type="generate_until",
            doc_to_text=lambda d, k=q_key: d[k] + single_word,
            doc_to_visual=_visual(img_key),
            doc_to_target=_target,
            generation_kwargs={"max_new_tokens": 32},
            metric_list=[{"metric": metric, "aggregation": "mean"}]))

    # MMStar: MCQ with embedded options; first-letter matching + per-
    # category accuracy channels (tasks/mmstar/utils.py:64-96)
    def _mmstar_match(pred, gt):
        answer = str(gt).lower().strip().replace("\n", " ")
        predict = str(pred).lower().strip().replace("\n", " ")
        if not predict:
            return 0.0
        if answer == predict[0]:
            return 1.0
        if predict[0] == "(" and len(predict) > 1 and answer == predict[1]:
            return 1.0
        if predict[:7] == "option " and len(predict) > 7 \
                and answer == predict[7]:
            return 1.0
        if predict[:14] == "the answer is " and len(predict) > 14 \
                and answer == predict[14]:
            return 1.0
        return 0.0

    def _mmstar_results(doc, resps):
        score = _mmstar_match(resps[0], doc["answer"])
        return {doc.get("category", "uncategorized"): score,
                "average": score}

    configs["mmstar"] = register_task("mmstar", TaskConfig(
        task="mmstar", dataset_path="Lin-Chen/MMStar", test_split="val",
        output_type="generate_until",
        doc_to_text=lambda d: d["question"] + letter_prompt,
        doc_to_visual=_visual(),
        doc_to_target=lambda d: d["answer"],
        process_results=_mmstar_results,
        generation_kwargs={"max_new_tokens": 4},
        metric_list=[{"metric": "average", "aggregation": "mean"}]))

    # HallusionBench image split: yes/no hallucination probes
    # (tasks/hallusion_bench/*; aAcc = per-answer accuracy)
    def _hb_target(d):
        return "yes" if str(d.get("gt_answer", "")).strip() == "1" \
            else "no"

    configs["hallusion_bench_image"] = register_task(
        "hallusion_bench_image", TaskConfig(
            task="hallusion_bench_image",
            dataset_path="lmms-lab/HallusionBench", test_split="image",
            output_type="generate_until",
            doc_to_text=lambda d: (d["question"]
                                   + "\nAnswer yes or no."),
            doc_to_visual=_visual(),
            doc_to_target=_hb_target,
            generation_kwargs={"max_new_tokens": 8},
            filter_list=[{"filter": "regex",
                          "pattern": r"(?i)\b(yes|no)\b", "group": 1,
                          "fallback": "[invalid]"},
                         {"filter": "strip"}],
            metric_list=[{"metric": "exact_match",
                          "aggregation": "mean"}]))

    # captioning tasks -> corpus-level CIDEr-D (coco_cap/textcaps/nocaps/
    # flickr30k yamls; the reference scores them with pycocoevalcap)
    cap_prompt = ("Provide a one-sentence caption for the provided "
                  "image.")
    for name, path, split, ref_key, img_key in (
        ("coco2014_cap_val", "lmms-lab/COCO-Caption", "val", "answer",
         "image"),
        ("textcaps_val", "lmms-lab/TextCaps", "val", "reference_strs",
         "image"),
        ("nocaps_val", "lmms-lab/NoCaps", "validation",
         "annotations_captions", "image"),
        ("flickr30k_test", "lmms-lab/flickr30k", "test", "caption",
         "image"),
    ):
        configs[name] = register_task(name, TaskConfig(
            task=name, dataset_path=path, test_split=split,
            output_type="generate_until",
            doc_to_text=lambda d: cap_prompt,
            doc_to_visual=_visual(img_key),
            doc_to_target=lambda d, k=ref_key: _list_target(d, k),
            generation_kwargs={"max_new_tokens": 64},
            metric_list=[{"metric": "cider_item",
                          "aggregation": "cider"}]))

    return configs


BUILTIN_TASKS = _register_all()
