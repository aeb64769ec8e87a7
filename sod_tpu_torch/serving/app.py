"""The SOD web application (ref ``app.py``, 4080 LoC).

Full route surface rebuilt on the stdlib WSGI micro-framework
(``sod_tpu_torch.serving.web``): model inference, auth with email verification
and OTP password reset, upload quotas and Stripe subscriptions, feedback,
the admin analytics JSON APIs, diagnostics and static/template serving.
Route names, JSON shapes and business rules follow the reference (cited
per handler).

Twin of ``sod_tpu/serving/app.py``: ``create_app`` and its routes are that
file's, with the model service built from the port's
``SelfMaskInference`` on ``device``.  ``main`` is the port's own
(``python -m sod_tpu_torch.serving.app --port 5000 [--no-model]
[--workers N]``): ``--workers`` > 1 boots the pool of
``sod_tpu_torch/serving/pool.py``, as the original's ``main`` does.
"""
from __future__ import annotations

import argparse
import datetime as dt
import os
import secrets
import time
from typing import Optional

from sod_tpu_torch.serving.db import (
    Database,
    check_password,
    hash_password,
    open_database,
)
from sod_tpu_torch.serving.emailer import Emailer, TokenStore
from sod_tpu_torch.serving.payments import PLANS, SUBSCRIPTION_DAYS, PaymentProvider
from sod_tpu_torch.serving.web import (
    App,
    HTTPError,
    Request,
    Response,
    jsonify,
    login_required,
    redirect,
)

MAX_CONTENT_LENGTH = 50 * 1024 * 1024          # ref app.py:154
ALLOWED_EXTENSIONS = {"png", "jpg", "jpeg", "gif", "bmp", "webp"}
FREE_TIER_UPLOADS = 3                          # ref app.py:2846-2870
_TEMPLATES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "templates")


def _allowed_file(filename: str) -> bool:
    return ("." in filename
            and filename.rsplit(".", 1)[1].lower() in ALLOWED_EXTENSIONS)


def _form_data(req) -> dict:
    """JSON body (object) or form fields.  ANY parsed non-dict JSON body —
    truthy (``[1]``, ``"x"``, ``5``) or falsy (``[]``, ``""``, ``0``,
    ``false``) — must 400, not AttributeError-500 at the first ``.get``;
    only the absence of a JSON body (no body / ``null``) falls back to
    form fields."""
    data = req.get_json()
    if data is None:
        return req.form
    if not isinstance(data, dict):
        raise HTTPError(400, "JSON body must be an object")
    return data


def _dominant_color(data: bytes) -> str:
    """ref ``app.py:2816-2829``: trivial dominant-color analysis stored as
    the upload's "result"."""
    import io

    import numpy as np
    from PIL import Image

    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        img.thumbnail((64, 64))
        mean = np.asarray(img, np.float32).mean(axis=(0, 1))
        names = ["Red", "Green", "Blue"]
        top = int(mean.argmax())
        if mean[top] - np.delete(mean, top).max() < 15:
            return "Mixed"
        return names[top]
    except Exception:
        return "Mixed"


def create_app(cfg=None, model_path: Optional[str] = None,
               db: Optional[Database] = None,
               upload_dir: Optional[str] = None,
               load_model: bool = True,
               secret_key: Optional[str] = None,
               allow_default_admin: bool = False,
               tokens=None, payments=None,
               device: str = "cuda") -> App:
    app = App(secret_key=secret_key or os.environ.get("SOD_SECRET_KEY",
                                                      secrets.token_hex(16)),
              static_dir=upload_dir or "static", static_url="/static/")
    app.allow_default_admin = allow_default_admin
    app.booted_at = time.time()
    db = db or open_database()
    emailer = Emailer()
    # injectable for multi-process serving (serving/pool.py): workers
    # pass DB-backed stores so signups/OTPs/stub checkouts created on one
    # worker resolve on any other
    tokens = tokens or TokenStore()
    payments = payments or PaymentProvider()
    upload_dir = upload_dir or "static"
    os.makedirs(os.path.join(upload_dir, "temp"), exist_ok=True)

    # --- model service (ref app.py:349-376: degrade gracefully) -----------
    inference = None
    if load_model:
        try:
            from sod_tpu_torch.config import Config
            from sod_tpu_torch.serving.inference import SelfMaskInference

            inference = SelfMaskInference(model_path=model_path,
                                          cfg=cfg or Config(),
                                          device=device)
        except Exception as e:  # noqa: BLE001
            print(f"model load failed, serving without inference: {e}")
            inference = None
    app.inference = inference
    app.db = db
    app.emailer = emailer
    app.tokens = tokens
    app.payments = payments

    # ======================================================================
    # pages (ref templates/: landing, dashboard, payments, feedback,
    # history, about/contact/demo/detection, admin, auth, 404/500)
    # ======================================================================
    def _render(name: str) -> Response:
        fp = os.path.join(_TEMPLATES, name)
        with open(fp) as f:
            return Response(f.read())

    # 404/500 HTML pages for browser requests (ref templates/404.html +
    # 500.html; JSON error handlers stay for API clients)
    for _status, _page in ((404, "404.html"), (500, "500.html")):
        with open(os.path.join(_TEMPLATES, _page)) as f:
            app.error_pages[_status] = f.read()

    def _user_page(name: str):
        """Login-gated page: redirect anonymous browsers to the landing
        page (ref login_required redirect branch, app.py:379-394)."""
        def handler(req: Request):
            if not (req.session.get("user_id")
                    or req.session.get("admin_id")):
                return redirect("/")
            return _render(name)
        return handler

    @app.route("/")
    def index(req: Request):
        """ref app.py:410-413 → First Page.html"""
        return _render("landing.html")

    @app.route("/dashboard")
    def dashboard(req: Request):
        """ref app.py:416-419 → index.html"""
        if not req.session.get("user_id"):
            return redirect("/")
        return _render("dashboard.html")

    @app.route("/admin")
    @app.route("/admin_entry")
    def admin_page(req: Request):
        """ref app.py:1530-1535 → Admin.html (the admin login page);
        an authenticated admin goes straight to the /view dashboard."""
        if req.session.get("admin_id"):
            return redirect("/view")
        return _render("admin.html")

    @app.route("/view")
    def view_page(req: Request):
        """ref app.py:2545-2564 → View.html (admin analytics dashboard)."""
        if not req.session.get("admin_id"):
            return redirect("/admin_entry")
        return _render("view.html")

    @app.route("/Contact.html")
    @app.route("/contact")
    def contact_page(req: Request):
        """ref app.py:422-429 → Contact.html (served at both paths)."""
        return _render("contact.html")

    @app.route("/about")
    def about_page(req: Request):
        return _render("about.html")

    @app.route("/demo")
    def demo_page(req: Request):
        return _render("demo.html")

    @app.route("/detection")
    def detection_page(req: Request):
        return _render("detection.html")

    @app.route("/auth/login")
    def auth_login_page(req: Request):
        return _render("auth/login.html")

    @app.route("/auth/register")
    def auth_register_page(req: Request):
        return _render("auth/register.html")

    app.route("/feedback")(_user_page("feedback.html"))
    app.route("/history")(_user_page("history.html"))
    app.route("/pay")(_user_page("pay.html"))
    app.route("/payment")(_user_page("payment.html"))
    app.route("/payment_success")(_user_page("payment_success.html"))
    app.route("/subscription-form")(_user_page("subscription-form.html"))
    app.route("/view_payment")(_user_page("view_payment.html"))

    # ======================================================================
    # auth (ref app.py:516-1702)
    # ======================================================================
    @app.route("/user_signup", methods=["POST"])
    def user_signup(req: Request):
        data = _form_data(req)
        name = data.get("name", "").strip()
        email = data.get("email", "").strip().lower()
        password = data.get("password", "")
        phone = data.get("phone", "")
        if not (name and email and password):
            raise HTTPError(400, "name, email and password are required")
        if db.query_one("SELECT User_ID FROM user_management WHERE Email=%s",
                        (email,)):
            raise HTTPError(400, "Email already registered")
        token = tokens.create_signup(name, email, hash_password(password),
                                     phone)
        link = f"/verify_signup/{token}"
        # the EMAIL needs an absolute URL (a mail client can't resolve a
        # bare path — ref uses url_for(..., _external=True)); the JSON
        # keeps the path for same-origin frontend use.  Prefer a CONFIGURED
        # base URL: req.host_url comes from the client-controlled Host
        # header, and a forged Host on a signup request would put an
        # attacker domain carrying the real verification token into the
        # victim's email (host-header-injection phishing)
        base = os.environ.get("SOD_BASE_URL", "").rstrip("/") or req.host_url
        abs_link = f"{base}{link}"
        emailer.send(email, "Verify your SOD account",
                     f"<p>Hi {name}, verify your account: "
                     f"<a href='{abs_link}'>{abs_link}</a> "
                     f"(valid 10 minutes)</p>")
        return jsonify({"success": True,
                        "message": "Verification email sent",
                        "verify_url": link})

    @app.route("/verify_signup/<token>")
    def verify_signup(req: Request, token: str):
        data = tokens.pop_signup(token)
        if data is None:
            raise HTTPError(400, "Invalid or expired verification link")
        # double-submitted signup forms yield TWO valid tokens for one
        # address; the second INSERT would hit UNIQUE(Email) and 500 —
        # re-check here for a controlled message
        if db.query_one("SELECT User_ID FROM user_management WHERE Email=%s",
                        (data["email"],)):
            raise HTTPError(400, "Email already registered")
        # timestamps are set explicitly: tables migrated from round 1 have
        # the columns WITHOUT a default (sqlite ALTER ADD cannot carry a
        # non-constant default), so relying on DEFAULT CURRENT_TIMESTAMP
        # would leave NULLs on upgraded databases
        user_id = db.execute(
            "INSERT INTO user_management (Name, Email, Password, Phone, "
            "created_at) VALUES (%s, %s, %s, %s, datetime('now'))",
            (data["name"], data["email"], data["password"], data["phone"]))
        req.session["user_id"] = user_id
        req.session["user_name"] = data["name"]
        return jsonify({"success": True, "user_id": user_id,
                        "message": "Account verified"})

    @app.route("/user_login", methods=["POST"])
    def user_login(req: Request):
        data = _form_data(req)
        email = data.get("email", "").strip().lower()
        password = data.get("password", "")
        row = db.query_one(
            "SELECT * FROM user_management WHERE Email=%s", (email,))
        if not row or not check_password(row["Password"] or "", password):
            raise HTTPError(401, "Invalid email or password")
        req.session["user_id"] = row["User_ID"]
        req.session["user_name"] = row["Name"]
        return jsonify({"success": True, "user_id": row["User_ID"],
                        "name": row["Name"]})

    @app.route("/admin_login", methods=["POST"])
    def admin_login(req: Request):
        """ref app.py:1636-1696: fixed-credential admin that self-inserts
        into the admin table on first login.

        Fail-closed deviation: the reference ships a@gmail.com/111 as the
        fixed credentials; here admin login is DISABLED unless
        ``SOD_ADMIN_PASSWORD`` is set explicitly (or the deployment opts
        into the reference defaults with ``SOD_ALLOW_DEFAULT_ADMIN=1`` —
        tests and local dev do).
        """
        if not (os.environ.get("SOD_ADMIN_PASSWORD")
                or os.environ.get("SOD_ALLOW_DEFAULT_ADMIN") == "1"
                or getattr(app, "allow_default_admin", False)):
            raise HTTPError(403, "Admin login disabled: set "
                                 "SOD_ADMIN_PASSWORD (or "
                                 "SOD_ALLOW_DEFAULT_ADMIN=1 for dev)")
        data = _form_data(req)
        email = data.get("email", "").strip().lower()
        password = data.get("password", "")
        expect_email = os.environ.get("SOD_ADMIN_EMAIL", "a@gmail.com")
        expect_pw = os.environ.get("SOD_ADMIN_PASSWORD", "111")
        if email != expect_email or password != expect_pw:
            raise HTTPError(401, "Invalid admin credentials")
        row = db.query_one("SELECT * FROM admin WHERE Email=%s", (email,))
        if row is None:
            # hashed, unlike the ref which stores the credential verbatim
            # (app.py:1660) — the table browser masks only the tail and a
            # DB dump must not leak SOD_ADMIN_PASSWORD
            admin_id = db.execute(
                "INSERT INTO admin (Name, Email, Password, Salary) "
                "VALUES (%s, %s, %s, %s)",
                ("Admin", email, hash_password(password), 100000))
        else:
            admin_id = row["Admin_ID"]
        req.session["admin_id"] = admin_id
        return jsonify({"success": True, "admin_id": admin_id})

    @app.route("/logout", methods=["GET", "POST"])
    def logout(req: Request):
        req.session.clear()
        return jsonify({"success": True})

    # --- OTP password reset (ref app.py:1035-1141) -------------------------
    @app.route("/forgot_password", methods=["POST"])
    def forgot_password(req: Request):
        data = _form_data(req)
        email = data.get("email", "").strip().lower()
        if not db.query_one(
                "SELECT User_ID FROM user_management WHERE Email=%s",
                (email,)):
            raise HTTPError(404, "No account with this email")
        otp = tokens.create_otp(email)
        emailer.send(email, "Your SOD password reset code",
                     f"<p>Your OTP is <b>{otp}</b> (valid 10 minutes)</p>")
        return jsonify({"success": True, "message": "OTP sent"})

    @app.route("/verify_otp", methods=["POST"])
    def verify_otp(req: Request):
        data = _form_data(req)
        ok = tokens.verify_otp(data.get("email", "").lower(),
                               data.get("otp", ""))
        if not ok:
            raise HTTPError(400, "Invalid or expired OTP")
        return jsonify({"success": True})

    @app.route("/reset_password", methods=["POST"])
    def reset_password(req: Request):
        data = _form_data(req)
        email = data.get("email", "").lower()
        if not tokens.verify_otp(email, data.get("otp", "")):
            raise HTTPError(400, "Invalid or expired OTP")
        tokens.consume_otp(email)
        db.execute("UPDATE user_management SET Password=%s WHERE Email=%s",
                   (hash_password(data.get("new_password", "")), email))
        return jsonify({"success": True, "message": "Password updated"})

    # ======================================================================
    # uploads / quota / results (ref app.py:2831-3056)
    # ======================================================================
    def _active_subscription(user_id: int):
        today = dt.date.today().isoformat()
        return db.query_one(
            "SELECT * FROM subscription WHERE User_ID=%s AND Status='Active' "
            "AND (End_Date IS NULL OR End_Date>=%s) "
            "ORDER BY Subscription_ID DESC", (user_id, today))

    def _check_quota(dbx, user_id: int):
        """Free tier: 3 uploads; else active subscription with remaining
        upload budget (-1 / NULL = unlimited) (ref app.py:2846-2915).
        A subscription whose upload budget is exhausted is marked
        ``expired`` like the reference (app.py:2900-2916) so Status-based
        analytics stop counting it as active.

        ``dbx`` is a ``Database`` OR an open ``db.transaction()`` handle.
        Returns ``(sub, error)`` instead of raising so a caller inside a
        transaction can COMMIT (persisting the Expired mark) before
        surfacing the 403.
        """
        today = dt.date.today().isoformat()
        sub = dbx.query_one(
            "SELECT * FROM subscription WHERE User_ID=%s AND Status='Active' "
            "AND (End_Date IS NULL OR End_Date>=%s) "
            "ORDER BY Subscription_ID DESC", (user_id, today))
        if sub is None:
            used = dbx.scalar("SELECT COUNT(*) FROM image WHERE user_id=%s",
                              (user_id,))
            if used >= FREE_TIER_UPLOADS:
                return None, HTTPError(403, "Free tier limit reached — "
                                            "subscribe to continue")
            return None, None
        limit = sub["Upload_Limit"]
        if limit is not None and limit >= 0 and sub["Uploads_Used"] >= limit:
            dbx.execute("UPDATE subscription SET Status='Expired' "
                        "WHERE Subscription_ID=%s", (sub["Subscription_ID"],))
            return None, HTTPError(403, "Subscription upload limit reached")
        return sub, None

    @app.route("/save_image_info", methods=["POST"])
    @login_required
    def save_image_info(req: Request):
        user_id = req.session["user_id"]
        up = req.files.get("image") or req.files.get("file")
        if up is None:
            raise HTTPError(400, "No image uploaded")
        if not _allowed_file(up.filename):
            raise HTTPError(400, "File type not allowed")
        if len(up.data) > MAX_CONTENT_LENGTH:
            raise HTTPError(413, "File too large (max 50 MB)")
        # quota check + insert must be one critical section: concurrent
        # uploads all reading COUNT(*) before any insert commits would let
        # a free user blow past the 3-upload limit (check-then-act race).
        # db.transaction() takes sqlite's write lock via BEGIN IMMEDIATE,
        # so the section is atomic across --workers N processes too (a
        # threading.Lock only covers threads of one process).
        with db.transaction() as txn:
            sub, quota_err = _check_quota(txn, user_id)
            if quota_err is None:
                # token suffix: same-second same-name uploads (across
                # users) must not overwrite each other's file on disk
                fname = (f"{int(time.time())}_{secrets.token_hex(4)}_"
                         f"{os.path.basename(up.filename)}")
                up.save(os.path.join(upload_dir, "temp", fname))
                ext = up.filename.rsplit(".", 1)[1].lower()
                image_id = txn.execute(
                    "INSERT INTO image (uploaded_image, file_type, "
                    "file_size, user_id, uploaded_at) VALUES (%s, %s, %s, "
                    "%s, datetime('now'))",
                    (fname, ext, len(up.data) // 1024, user_id))
                result = (f"Dominant Color: {_dominant_color(up.data)}, "
                          f"Type: {ext}, Size: {len(up.data) / 1024:.2f} KB")
                txn.execute(
                    "INSERT INTO result (Result_data, Image_ID, User_ID, "
                    "processed_at) VALUES (%s, %s, %s, datetime('now'))",
                    (result, image_id, user_id))
                if sub is not None:
                    txn.execute(
                        "UPDATE subscription SET Uploads_Used="
                        "Uploads_Used+1 WHERE Subscription_ID=%s",
                        (sub["Subscription_ID"],))
        if quota_err is not None:
            raise quota_err
        return jsonify({"success": True, "image_id": image_id,
                        "filename": fname, "result": result})

    @app.route("/upload_image", methods=["POST"])
    @login_required
    def upload_image(req: Request):
        return save_image_info(req)

    # ======================================================================
    # inference (ref app.py:3799-3920)
    # ======================================================================
    @app.route("/predict", methods=["POST"])
    @login_required
    def predict(req: Request):
        if app.inference is None:
            raise HTTPError(500, "Model not available")
        up = req.files.get("image") or req.files.get("file")
        if up is None:
            raise HTTPError(400, "No image uploaded")
        if not _allowed_file(up.filename):
            raise HTTPError(400, "File type not allowed")
        if len(up.data) > MAX_CONTENT_LENGTH:
            raise HTTPError(413, "File too large (max 50 MB)")
        from PIL import Image
        import io

        try:
            Image.open(io.BytesIO(up.data)).verify()   # ref app.py:3855-3863
        except Exception:
            raise HTTPError(400, "Corrupted or invalid image file")
        refine = (req.form.get("refine") or
                  req.query.get("refine", [""])[0]) in ("1", "true", "yes")
        out = app.inference.predict(up.data, refine=refine)
        out["success"] = True
        return jsonify(out)

    # ======================================================================
    # payments (ref app.py:3060-3215)
    # ======================================================================
    @app.route("/create-checkout-session", methods=["POST"])
    @login_required
    def create_checkout(req: Request):
        data = _form_data(req)
        plan = (data.get("plan") or "").lower()
        if plan not in PLANS:
            raise HTTPError(400, f"Unknown plan: {plan}")
        session = payments.create_checkout_session(
            plan, req.session["user_id"],
            success_url="/payment-success", cancel_url="/dashboard")
        return jsonify(session)

    @app.route("/payment-success", methods=["GET", "POST"])
    @login_required
    def payment_success(req: Request):
        sid = (req.query.get("session_id", [None])[0]
               or (req.get_json() or {}).get("session_id"))
        if not sid:
            raise HTTPError(400, "session_id required")
        # One-shot confirmation: a session_id creates at most ONE
        # subscription (the reference re-inserts a fresh 30-day sub on
        # every call, ref app.py:3101-3182 — replayable).  Re-visits of
        # the success URL are idempotent.
        existing = db.query_one(
            "SELECT * FROM subscription WHERE Session_ID=%s", (sid,))
        if existing is not None:
            return jsonify({"success": True, "already_processed": True,
                            "subscription_id": existing["Subscription_ID"],
                            "plan": existing["Plan_Type"],
                            "valid_until": existing["End_Date"]})
        confirmed = payments.confirm(sid)
        if confirmed is None:
            raise HTTPError(400, "Payment not completed")
        plan = PLANS[confirmed["plan"]]
        start = dt.date.today()
        end = start + dt.timedelta(days=SUBSCRIPTION_DAYS)
        try:
            sub_id = db.execute(
                "INSERT INTO subscription (Plan_Type, Start_Date, End_Date, "
                "Status, Upload_Limit, Uploads_Used, Amount_Paid, "
                "Payment_Method, User_ID, Session_ID) VALUES (%s, %s, %s, "
                "'Active', %s, 0, %s, 'Stripe', %s, %s)",
                (plan["name"], start.isoformat(), end.isoformat(),
                 plan["upload_limit"], plan["price_usd"],
                 confirmed["user_id"], sid))
        except Exception:
            # concurrent confirmation of the same session lost the
            # idx_sub_session race — idempotent success, not a 500
            existing = db.query_one(
                "SELECT * FROM subscription WHERE Session_ID=%s", (sid,))
            if existing is None:
                raise
            return jsonify({"success": True, "already_processed": True,
                            "subscription_id": existing["Subscription_ID"],
                            "plan": existing["Plan_Type"],
                            "valid_until": existing["End_Date"]})
        return jsonify({"success": True, "subscription_id": sub_id,
                        "plan": plan["name"], "valid_until": end.isoformat()})

    @app.route("/get_payment_info")
    @login_required
    def get_payment_info(req: Request):
        sub = _active_subscription(req.session["user_id"])
        if sub is None:
            used = db.scalar("SELECT COUNT(*) FROM image WHERE user_id=%s",
                             (req.session["user_id"],))
            return jsonify({"plan": "Free", "uploads_used": used,
                            "upload_limit": FREE_TIER_UPLOADS})
        return jsonify({"plan": sub["Plan_Type"],
                        "uploads_used": sub["Uploads_Used"],
                        "upload_limit": sub["Upload_Limit"],
                        "valid_until": sub["End_Date"],
                        "status": sub["Status"]})

    # ======================================================================
    # feedback (ref app.py:2666-2814)
    # ======================================================================
    @app.route("/submit_feedback", methods=["POST"])
    @login_required
    def submit_feedback(req: Request):
        """ref app.py:2666-2771: accepts the ref's form field names
        (``Feedback_Type``/``rating``/``Feedback_Text``/``result_id``) and
        the simpler type/text JSON shape; 'result'-type feedback resolves
        and validates the user's Result_ID."""
        data = _form_data(req)
        user_id = req.session["user_id"]
        ftype = (data.get("Feedback_Type") or data.get("type")
                 or "general").strip().lower()
        if ftype not in ("general", "result", "bug", "suggestion"):
            raise HTTPError(400, "Invalid feedback type. Must be one of: "
                                 "general, result, bug, suggestion")
        try:
            rating = int(data.get("rating", 0))
        except (TypeError, ValueError):
            rating = 0
        if not 1 <= rating <= 5:
            raise HTTPError(400, "Rating must be between 1 and 5")
        text = data.get("Feedback_Text") or data.get("text") or ""
        if not text.strip():
            # ref app.py:2685 rejects missing fields outright
            raise HTTPError(400, "All fields are required")
        result_id = data.get("result_id")
        if ftype == "result":
            if not result_id:   # most recent result (ref app.py:2705-2718)
                row = db.query_one(
                    "SELECT Result_ID FROM result WHERE User_ID=%s "
                    "ORDER BY processed_at DESC LIMIT 1", (user_id,))
                if row is None:
                    raise HTTPError(400, "No recent results found for "
                                         "result feedback")
                result_id = row["Result_ID"]
            elif db.query_one(
                    "SELECT Result_ID FROM result WHERE Result_ID=%s AND "
                    "User_ID=%s", (result_id, user_id)) is None:
                raise HTTPError(400, "Invalid result ID")
        else:
            result_id = None
        fid = db.execute(
            "INSERT INTO feedback (Rating, Feedback_Type, Feedback_Text, "
            "User_ID, Result_ID, created_at) VALUES (%s, %s, %s, %s, %s, "
            "datetime('now'))", (rating, ftype, text, user_id, result_id))
        return jsonify({"success": True, "feedback_id": fid,
                        "message": "Feedback submitted successfully!"})

    @app.route("/get_feedback")
    @login_required
    def get_feedback(req: Request):
        """ref app.py:2774-2814: the caller's own feedback, newest first."""
        rows = db.query(
            "SELECT Feedback_ID, Rating, Feedback_Type, Feedback_Text, "
            "User_ID, Result_ID FROM feedback WHERE User_ID = %s "
            "ORDER BY Feedback_ID DESC", (req.session.get("user_id"),))
        return jsonify({"success": True, "data": rows, "feedback": rows})

    # ======================================================================
    # admin analytics APIs (ref app.py:1705-2664, 3218-3797) — the full
    # route-for-route surface lives in sod_tpu/serving/analytics.py
    # ======================================================================
    def admin_required(fn):
        def wrapper(req: Request, *a, **kw):
            if not req.session.get("admin_id"):
                return jsonify({"error": "Admin authentication required"},
                               status=401)
            return fn(req, *a, **kw)

        wrapper.__name__ = fn.__name__
        return wrapper

    from sod_tpu_torch.serving.analytics import register_analytics

    register_analytics(app, db)

    @app.route("/api/overview")
    @admin_required
    def api_overview(req: Request):
        """Round-1 alias of ref /api/stats/overview (app.py:1821-1880)
        kept for the admin dashboard; adds admin count."""
        return jsonify({
            "total_users": db.scalar("SELECT COUNT(*) FROM user_management"),
            "total_images": db.scalar("SELECT COUNT(*) FROM image"),
            "total_results": db.scalar("SELECT COUNT(*) FROM result"),
            "active_subscriptions": db.scalar(
                "SELECT COUNT(*) FROM subscription WHERE Status='Active'"),
            "total_revenue": db.scalar(
                "SELECT COALESCE(SUM(Amount_Paid), 0) FROM subscription"),
            "total_feedback": db.scalar("SELECT COUNT(*) FROM feedback"),
            "average_rating": db.scalar(
                "SELECT AVG(Rating) FROM feedback"),
            "total_admins": db.scalar("SELECT COUNT(*) FROM admin"),
        })

    @app.route("/api/analytics/feedback")
    @admin_required
    def api_feedback(req: Request):
        """Round-1 alias — the ref name is /api/feedback/analytics."""
        return jsonify({
            "total": db.scalar("SELECT COUNT(*) FROM feedback"),
            "average_rating": db.scalar("SELECT AVG(Rating) FROM feedback"),
            "by_rating": db.query(
                "SELECT Rating, COUNT(*) AS count FROM feedback "
                "GROUP BY Rating ORDER BY Rating"),
            "by_type": db.query(
                "SELECT Feedback_Type, COUNT(*) AS count FROM feedback "
                "GROUP BY Feedback_Type"),
        })

    @app.route("/api/analytics/admins")
    @admin_required
    def api_admins(req: Request):
        rows = db.query("SELECT Admin_ID, Name, Email, Salary FROM admin")
        return jsonify({"total": len(rows), "admins": rows})

    @app.route("/api/recent_activity")
    @admin_required
    def api_recent(req: Request):
        """ref app.py:2617-2664: latest uploads/results/feedback."""
        return jsonify({
            "images": db.query(
                "SELECT * FROM image ORDER BY image_id DESC LIMIT 10"),
            "results": db.query(
                "SELECT Result_ID, Result_data, Image_ID, User_ID FROM "
                "result ORDER BY Result_ID DESC LIMIT 10"),
            "feedback": db.query(
                "SELECT * FROM feedback ORDER BY Feedback_ID DESC LIMIT 10"),
        })

    @app.route("/hash_passwords", methods=["GET", "POST"])
    @admin_required
    def hash_passwords(req: Request):
        """Migration helper (ref app.py:2524): hash any plaintext passwords."""
        rows = db.query("SELECT User_ID, Password FROM user_management")
        updated = 0
        for r in rows:
            pw = r["Password"] or ""
            if pw and not pw.startswith(("scrypt:", "pbkdf2:")):
                db.execute("UPDATE user_management SET Password=%s "
                           "WHERE User_ID=%s", (hash_password(pw),
                                                r["User_ID"]))
                updated += 1
        return jsonify({"success": True, "updated": updated})

    # ======================================================================
    # diagnostics (ref app.py:3973-4080)
    # ======================================================================
    @app.route("/test_db")
    def test_db(req: Request):
        return jsonify(db.health())

    @app.route("/test_connection")
    def test_connection(req: Request):
        # identify WHICH server answered: with a port takeover (a stale
        # process still bound, single-TPU-client rule) the basic ok/true
        # line is indistinguishable between two servers — pid + boot time
        # + model config make the mixup diagnosable from the client side
        info = {"status": "ok", "time": time.time(),
                "model_loaded": app.inference is not None,
                "payment_mode": payments.mode,
                "pid": os.getpid(), "booted_at": app.booted_at}
        if getattr(app, "worker_index", None) is not None:
            info["worker_index"] = app.worker_index
        if app.inference is not None:
            icfg = app.inference.cfg
            info["model"] = {
                "arch": icfg.arch,
                "quantize": getattr(icfg, "quantize", "none"),
                "compute_dtype": icfg.compute_dtype,
                "n_queries": app.inference.mcfg.n_queries,
                "micro_batching": bool(getattr(app.inference,
                                               "micro_batching", False)),
            }
            # pool mode: the model lives in the broker process, not here
            if getattr(app.inference, "is_remote", False):
                info["model"]["broker_pid"] = app.inference.broker_pid
        return jsonify(info)

    return app


def main(argv=None) -> None:
    p = argparse.ArgumentParser("sod-tpu-torch serve")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--model", type=str, default=None,
                   help="torch checkpoint in the reference's layout; "
                        "default: seeded random weights")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--no-model", action="store_true",
                   help="serve the web app without building the model "
                        "service (/predict then answers that no model is "
                        "loaded)")
    p.add_argument("--workers", type=int, default=1,
                   help="N>1: spawn N HTTP worker processes sharing the "
                        "port (SO_REUSEPORT); this process keeps the card "
                        "and serves them over a unix-socket broker, the "
                        "workers see no card (they refine on the CPU). "
                        "Requires a file DB (SOD_DB_PATH).")
    p.add_argument("--allow-default-admin", action="store_true",
                   help="enable the reference's fixed admin credentials "
                        "(dev only; otherwise set SOD_ADMIN_PASSWORD)")
    p.add_argument("--quantize", choices=["none", "int8"], default=None,
                   help="int8: serve the W8A8 fused encoder "
                        "(ops/fused_block_int8)")
    args = p.parse_args(argv)

    from sod_tpu_torch.config import Config, load_config
    from sod_tpu_torch.serving.web import make_threaded_server

    cfg = load_config(args.config) if args.config else Config()
    if args.quantize is not None:
        cfg = cfg.replace(quantize=args.quantize)
    if args.workers > 1:
        from sod_tpu_torch.serving.pool import serve_pool

        serve_pool(port=args.port, workers=args.workers, cfg=cfg,
                   device=args.device, model_path=args.model,
                   load_model=not args.no_model,
                   allow_default_admin=args.allow_default_admin)
        return
    app = create_app(cfg=cfg, load_model=False,
                     allow_default_admin=args.allow_default_admin)
    if not args.no_model:
        from sod_tpu_torch.serving.inference import SelfMaskInference

        app.inference = SelfMaskInference(model_path=args.model, cfg=cfg,
                                          device=args.device)
    print(f"serving on http://0.0.0.0:{args.port}", flush=True)
    make_threaded_server("0.0.0.0", args.port, app).serve_forever()


if __name__ == "__main__":
    main()
